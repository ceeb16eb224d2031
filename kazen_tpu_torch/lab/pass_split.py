"""Where a render pass's time goes, read from the program's own spans and
counters (``utils/metrics.py``): BASELINE's configuration 4 (kazen-con-2,
``examples/baseline_configs.py:config_scene(4)``) at 1920x1080, or another
of its configurations (``--config 3``: kazen-con-1) at a given size,
rendered as the CLI renders it (``render(scene, static, spp=...)``, which
builds its sampler tables on each call).

One process, the tracer on unless said otherwise:

* set-up (``setup_split``): ``compile_scene``, the CUDA builds
  (``cuda_build`` spans; a fresh checkout builds) and a warm-up call of one
  pass;
* ``calls`` pairs of render calls of ``spp`` passes, the tracer off in one
  and on in the other (in turns: off, on, on, off, ...), each timed on the
  host clock to a synchronize: pixel-samples/s off and on. The traced calls
  give the split of a pass (``split``): host reads a pass by site, the host
  ms blocked in them, the host ms enqueuing (the pass span less its syncs),
  the device-clock ms of a pass (its CUDA events) and the pmj02bn tables'
  ms a call, with the ms their copies onto the card blocked;
* on the card, one call of ``profiled`` passes under torch.profiler: the
  device's busy ms a pass, hence the idle share of the unprofiled passes
  (100 x (1 - busy / device ms a pass), and the same against the untraced
  calls' rate), and the device's idle gaps named by the innermost program
  span open on the host when each began (``name_gaps``);
* on the card, one call of ``sync_passes`` passes under
  ``torch.cuda.set_sync_debug_mode("warn")``: each synchronizing call, by
  the innermost line of the package that made it, against the host-read
  counter of the same call.

``python -m kazen_tpu_torch.lab.pass_split [--config 3 --size 3840x2160
--spp 8] [--json FILE]`` runs it on the card; ``--device cpu --size 32x18 --spp 2 --calls 1`` runs it small on the
CPU (no profile, no sync debug mode).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import time
import traceback
import warnings

import torch

from ..core.device import card_line, resolve_device
from ..examples.baseline_configs import at_size, config_scene
from ..integrate.render import render
from ..scene.compiler import compile_scene
from ..utils import metrics
from . import device_activities

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OTHER = "other"  # an idle gap that begins outside every program span


def _inside(span, by_id, name):
    """The nearest enclosing span named ``name`` of ``span``, or None."""
    p = span.parent
    while p is not None and p in by_id:
        if by_id[p].name == name:
            return by_id[p]
        p = by_id[p].parent
    return None


def split(collected: dict) -> dict:
    """The readings of traced render calls, from what ``metrics.collect()``
    returned: a pass is a ``render.pass`` span (the full pixel grid), its
    syncs the ``sync`` spans inside it."""
    spans = collected["spans"]
    by_id = {s.id: s for s in spans}
    passes = [s for s in spans if s.name == "render.pass"]
    if not passes:
        return {}
    blocked, sites, tables_blocked = {p.id: 0.0 for p in passes}, {}, 0.0
    for s in spans:
        if s.name != "sync":
            continue
        p = _inside(s, by_id, "render.pass")
        if p is not None:
            blocked[p.id] += s.host_ms
            sites[s.attrs["site"]] = sites.get(s.attrs["site"], 0) + 1
        elif _inside(s, by_id, "sampler.tables") is not None:
            tables_blocked += s.host_ms
    n = len(passes)
    device_ms = [p.device_ms for p in passes if p.device_ms is not None]
    tables = [s.host_ms for s in spans if s.name == "sampler.tables"]
    return {
        "passes": n,
        "syncs_per_pass": sum(sites.values()) / n,
        "syncs_by_site": {k: v / n for k, v in sorted(sites.items())},
        "host_blocked_ms_per_pass": sum(blocked.values()) / n,
        "host_enqueue_ms_per_pass": statistics.median(p.host_ms - blocked[p.id] for p in passes),
        "pass_host_ms": statistics.median(p.host_ms for p in passes),
        "pass_device_ms": statistics.median(device_ms) if device_ms else None,
        "sampler_tables_ms_per_call": statistics.median(tables) if tables else None,
        "sampler_tables_blocked_ms_per_call": tables_blocked / len(tables) if tables else None,
    }


def setup_split(collected: dict) -> dict:
    """Seconds of set-up: the ``compile_scene`` spans, the ``cuda_build``
    spans, and the warm-up ``render.call`` less the builds inside it."""
    spans = collected["spans"]

    def total(name):
        return sum(s.host_ms for s in spans if s.name == name) / 1e3

    return {"compile_scene_s": total("compile_scene"), "cuda_build_s": total("cuda_build"),
            "warmup_s": total("render.call") - total("cuda_build")}


def _label(span) -> str:
    return f"sync {span.attrs['site']}" if span.name == "sync" else span.name


def kernel_base(name: str) -> str:
    """A device activity's name without return type, namespaces and
    template arguments."""
    name = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"[<(].*", "", name.replace("void ", "", 1)).split("::")[-1].strip()
    return base or name[:60]


def name_gaps(activities, spans, top: int = 10) -> dict:
    """The device's idle gaps between ``activities`` ([(start ns, end ns,
    name)] on the profiler's clock), each named by the innermost span of
    ``spans`` open on the host when it began (``other`` where none was) and
    the activity that ended it. Returns the ``top`` longest gaps ([name,
    ms]) and the gap ms by host span (``by_span``)."""
    acts = sorted(activities)
    gaps, end = [], None
    for s, e, name in acts:
        if end is not None and s > end:
            gaps.append((end, s, kernel_base(name)))
        end = e if end is None else max(end, e)
    ordered = sorted(spans, key=lambda sp: (sp.start_ns, -sp.end_ns))
    stack, i, named, by_span = [], 0, [], {}
    for g0, g1, kernel in gaps:
        while i < len(ordered) and ordered[i].start_ns <= g0:
            while stack and stack[-1].end_ns <= ordered[i].start_ns:
                stack.pop()
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1].end_ns <= g0:
            stack.pop()
        host = _label(stack[-1]) if stack else OTHER
        ms = (g1 - g0) / 1e6
        named.append([f"{host} -> {kernel}", ms])
        by_span[host] = by_span.get(host, 0.0) + ms
    named.sort(key=lambda g: -g[1])
    return {"gaps": named[:top], "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def _union_ms(activities) -> float:
    total, cur = 0, None
    for s, e, _ in sorted(activities):
        if cur is None or s > cur[1]:
            total += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return (total + (0 if cur is None else cur[1] - cur[0])) / 1e6


def profiled(scene, static, device, passes: int) -> dict:
    """One render call of ``passes`` passes under torch.profiler, the tracer
    on: the device's busy ms a pass, the idle gaps named by host span, and
    the largest gap between a program span and the profiler's ``kazen:``
    range of the same span (the shared clock)."""
    from torch.profiler import ProfilerActivity, profile

    metrics.collect()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(scene, static, spp=passes, device=device)
        torch.cuda.synchronize(device)
    spans = metrics.collect()["spans"]
    events = prof.profiler.kineto_results.events()
    # a span's range is also recorded as the device's time under it
    acts = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in device_activities(events) if not e.name().startswith(metrics.PREFIX)]
    ranges = sorted(e.start_ns() for e in events
                    if e.device_type() == torch.autograd.DeviceType.CPU
                    and e.name() == metrics.PREFIX + "render.pass")
    starts = sorted(s.start_ns for s in spans if s.name == "render.pass")
    skew = max((abs(a - b) / 1e6 for a, b in zip(ranges, starts)), default=None)
    return {"passes": passes, "launches_per_pass": len(acts) / passes,
            "busy_ms_per_pass": _union_ms(acts) / passes, "clock_skew_ms": skew,
            "pass_ranges": len(ranges), **name_gaps(acts, spans)}


def sync_sites(fn) -> dict:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: each
    synchronizing call by the innermost line of the package on its stack
    (``file:line function``), or else the innermost line of all."""
    found = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [fr for fr in traceback.extract_stack()[:-1] if fr.filename != warnings.__file__]
        ours = [fr for fr in stack if fr.filename.startswith(PACKAGE)
                and not fr.filename.endswith("pass_split.py")]
        fr = ours[-1] if ours else stack[-1]
        where = (os.path.relpath(fr.filename, PACKAGE) if ours
                 else f"outside the package: {os.path.basename(fr.filename)}")
        where = f"{where}:{fr.lineno} {fr.name}"
        found[where] = found.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sorted(found.items()))


def _timed_call(scene, static, device, spp: int) -> float:
    """pixel-samples/s of one render call, on the host clock to a sync."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    render(scene, static, spp=spp, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return static.width * static.height * spp / (time.perf_counter() - t0)


def main(device="cuda", size=(1920, 1080), spp=16, calls=3, profiled_passes=2,
         sync_passes=2, json_path=None, config=4) -> dict:
    dev = resolve_device(device)
    where = card_line() if dev.type == "cuda" else "cpu"
    desc = at_size(config_scene(config), *size)
    out = {"config": config, "resolution": "x".join(map(str, size)), "spp": spp,
           "device": str(dev), "card": where}
    metrics.collect()
    with metrics.tracing():
        scene, static = compile_scene(desc, device=dev)
        render(scene, static, spp=1, device=dev)
    out["setup"] = setup_split(metrics.collect())
    print(f"set-up: {out['setup']} [{where}]", flush=True)

    rates = {False: [], True: []}
    for k in range(calls):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            with metrics.tracing(on):
                rates[on].append(_timed_call(scene, static, dev, spp))
    out["pixel_samples_per_s"] = {"off": rates[False], "on": rates[True]}
    out["split"] = split(metrics.collect())
    med_off, med_on = statistics.median(rates[False]), statistics.median(rates[True])
    out["tracer_cost_share"] = 1.0 - med_on / med_off
    print(f"pixel-samples/s off {rates[False]}, on {rates[True]}: the tracer costs "
          f"{100 * out['tracer_cost_share']:.3f}% [{where}]", flush=True)
    print(f"split: {json.dumps(out['split'])} [{where}]", flush=True)

    if dev.type == "cuda":
        with metrics.tracing():
            out["profiled"] = prof = profiled(scene, static, dev, profiled_passes)
        busy = prof["busy_ms_per_pass"]
        lanes = static.width * static.height
        out["device_idle_share_unprofiled"] = 100 * (1 - busy / out["split"]["pass_device_ms"])
        out["device_idle_share_by_rate"] = 100 * (1 - busy / (1e3 * lanes / med_off))
        print(f"profiled: {json.dumps(prof)} [{where}]", flush=True)
        print(f"idle share, unprofiled passes: {out['device_idle_share_unprofiled']:.3f}%; "
              f"by the untraced rate: {out['device_idle_share_by_rate']:.3f}% [{where}]",
              flush=True)
        metrics.collect()
        with metrics.tracing():
            sites = sync_sites(lambda: render(scene, static, spp=sync_passes, device=dev))
            reads = metrics.collect()["host_reads"]
        out["sync_debug"] = {"passes": sync_passes, "warned": sites,
                             "warned_total": sum(sites.values()), "host_reads": reads,
                             "host_reads_total": sum(reads.values())}
        print(f"sync debug: {json.dumps(out['sync_debug'])} [{where}]", flush=True)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--config", type=int, default=4, help="BASELINE configuration 1-4")
    parser.add_argument("--size", default="1920x1080")
    parser.add_argument("--spp", type=int, default=16)
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--json", help="write the results to this file")
    args = parser.parse_args()
    main(args.device, tuple(int(v) for v in args.size.split("x")), args.spp, args.calls,
         json_path=args.json, config=args.config)
