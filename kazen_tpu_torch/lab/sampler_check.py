"""The sampler's draw kernel held against the plain version over a pass's
draws, and the main path's route.

``check_draws`` runs a render pass's sequence of draws for one sampler
spec over a frame of lanes (the stream init, the pixel jitter, the
aperture, then each bounce's Russian roulette from depth 3, the four NEE
uniforms and the BSDF's s1 and s2, with the stream re-laid as the ordered
permute hands it on: strided columns of one (N, 7) tensor), each draw by
its route (the kernel on the card) and by the plain version
(``streams._*_plain``) on the same input. Every output field is compared
bit for bit (floats as their int32 bits), the route is timed over
``reps`` launches and the plain version once, beside the draw's bound by
bytes (``lane_bytes``). ``route_pass`` renders one pass with the tracer
on: the draws by route, the host reads of core/rng.py and the kernel's
launches.

On the CPU the route is the plain version, so the check compares it with
itself (a rehearsal of the script). ``python -m
kazen_tpu_torch.lab.sampler_check --config 4`` runs BASELINE config 4
(con-2, pmj02bn) over 1920x1080 lanes (``--config 2``: config 2's
stratified 128-spp spec); ``--size 64x36 --device cpu`` rehearses it.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..core import rng
from ..core.device import resolve_device
from ..integrate.render import pixel_grid, render, sampler_spec
from ..samplers import draw_kernel, streams
from ..utils import metrics
from .shade_check import HBM_BYTES_PER_S, _bits, _timed

FIELDS = streams.StreamState._fields


def lane_bytes(kind: str, draw: str) -> int:
    """Bytes a lane of the kernel reads and writes once for ``draw`` (init,
    pixel, 1d, 2d): the stream fields it reads, its table lookups, the
    fields it writes and its uniforms (8 B a field, 4 B a float)."""
    if draw == "init":
        return 2 * 8 + 4 * 8  # px, py -> state, inc, dim, sample_index
    if draw == "pixel" and kind == "pmj02bn":
        return 3 * 8 + 8 + 8  # px, py, sample_index, a tile pair -> u
    width = 1 if draw == "1d" else 2  # another kind's pixel draw is its next_2d
    if kind == "independent":
        return 2 * 8 + 8 + 4 * width  # state, inc -> state, u
    if kind == "pmj02bn":
        lookups = 4 if width == 1 else 8 + 2 * 4  # blue noise (and a point pair)
        return 4 * 8 + lookups + 8 + 4 * width  # dim, px, py, sample_index -> dim, u
    return 6 * 8 + 2 * 8 + 4 * width  # every field -> state, dim, u


def pass_draws(depth: int, nee: bool):
    """A pass's draws in order: (name, draw), a bounce's names starting
    with "b<depth> ", its first draw at the bounce's head."""
    out = [("init", "init"), ("jitter", "pixel"), ("aperture", "2d")]
    for d in range(1, depth + 1):
        names = (["rr"] if d > 3 else []) + (["pick", "tri", "a", "b"] if nee else []) + ["s1"]
        out += [(f"b{d} {k}", "1d") for k in names] + [(f"b{d} s2", "2d")]
    return out


def _routed(spec, draw, st, px, py, sample, jump):
    if draw == "init":
        return streams.init_stream_jump(spec, px, py, sample, jump), None
    fn = {"pixel": streams.next_pixel_2d, "1d": streams.next_1d, "2d": streams.next_2d}[draw]
    return fn(spec, st)


def _plain(spec, draw, st, px, py, sample, jump):
    if draw == "init":
        return streams._init_plain(spec, px, py, sample, jump), None
    if draw == "pixel" and spec.kind == "pmj02bn":
        return streams._pixel_2d_plain(spec, st)
    return (streams._next_1d_plain if draw == "1d" else streams._next_2d_plain)(spec, st)


def _differ(got, want) -> dict:
    """{field: lanes whose bits differ} of two (StreamState, u) pairs."""
    out = {}
    for name, a, b in [(f, getattr(got[0], f), getattr(want[0], f)) for f in FIELDS] + [
            ("u", got[1], want[1])]:
        if a is None or b is None:
            out[name] = 0 if a is b else -1
            continue
        a, b = _bits(a.contiguous()), _bits(b.contiguous())
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{name}: {a.dtype} {tuple(a.shape)} against "
                             f"{b.dtype} {tuple(b.shape)}")
        ne = a != b
        out[name] = int(ne.reshape(ne.shape[0], -1).any(1).sum())
    return out


def _launch_ms(fn, reps: int, device):
    """(fn()'s last result, ms a call) over ``reps`` calls after one more:
    on the card the device time between CUDA events, the host having queued
    the calls behind a sleeping kernel (so the host's own cost is not
    timed); on the CPU the host clock."""
    fn()  # a kernel's first launch loads its module
    if device.type != "cuda":
        out, ms = _timed(lambda: [fn() for _ in range(reps)][-1], device)
        return out, ms / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)  # ~60 ms of device time to queue behind
    start.record()
    out = [fn() for _ in range(reps)][-1]
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / reps


def _as_permuted(st):
    """The stream as the ordered permute hands it on: strided columns of
    one (N, 7) tensor (here in the lanes' own order)."""
    lane = torch.arange(st.px.shape[0], device=st.px.device)
    return streams.StreamState(*torch.stack([*st, lane], dim=1)[:, :6].unbind(1))


def check_draws(spec, px, py, sample: int = 5, depth: int = 5, nee: bool = True,
                reps: int = 10) -> list:
    """One record a draw of a pass over the lanes (px, py): its route,
    lanes differing by field, ms a launch by its route (mean of ``reps``),
    the plain version's ms and the bound by bytes."""
    dev = px.device
    sample %= spec.effective_sample_count
    jump = rng.advance_constants(sample * 65536)
    n = px.shape[0]
    st, records = None, []
    for name, draw in pass_draws(depth, nee):
        if records and name.split()[0] != records[-1]["name"].split()[0]:
            st = _as_permuted(st)  # a bounce's head, after the permute
        got, ms = _launch_ms(lambda: _routed(spec, draw, st, px, py, sample, jump), reps, dev)
        want, plain_ms = _timed(lambda: _plain(spec, draw, st, px, py, sample, jump), dev)
        records.append({
            "name": name, "draw": draw, "lanes": n, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": n * lane_bytes(spec.kind, draw) / HBM_BYTES_PER_S * 1e3,
            "differ": _differ(got, want),
        })
        st = got[0]
    return records


def route_pass(scene, static) -> dict:
    """One render() pass with the tracer on: the draws by route, the host
    reads of core/rng.py by site and the draw kernel's launches."""
    metrics.collect()
    before = draw_kernel.DRAWS.launches
    with metrics.tracing():
        render(scene, static, spp=1, device=scene.device)
    got = metrics.collect()
    return {"sampler_route": got["sampler_route"],
            "rng_reads": {k: v for k, v in got["host_reads"].items()
                          if k.startswith("core/rng.py")},
            "launches": draw_kernel.DRAWS.launches - before}


def summary(records: list) -> dict:
    """Totals of check_draws: lanes differing by field over the draws, and
    per pass the route's, the bound's and the plain version's ms."""
    differ = {f: sum(r["differ"][f] for r in records) for f in (*FIELDS, "u")}
    return {
        "draws": len(records), "differ": differ, "equal": not any(differ.values()),
        "ms_per_pass": sum(r["ms"] for r in records),
        "bound_ms_per_pass": sum(r["bound_ms"] for r in records),
        "plain_ms_per_pass": sum(r["plain_ms"] for r in records),
        "ms_by_draw": {d: sum(r["ms"] for r in records if r["draw"] == d)
                       / max(sum(1 for r in records if r["draw"] == d), 1)
                       for d in ("init", "pixel", "1d", "2d")},
    }


def main(config="4", size=(1920, 1080), device="cuda", sample: int = 5,
         route: bool = True) -> dict:
    """BASELINE config ``config``'s sampler spec over a ``size`` (w, h) grid
    of lanes, its pass's draws held (``check_draws``); with ``route``, one
    render() pass of the configuration at ``size`` (``route_pass``). Prints
    a line a draw and returns the summary with the records."""
    from ..examples import baseline_configs as bc
    from ..scene.compiler import compile_scene

    dev = resolve_device(device)
    desc = bc.at_size(bc.config_scene(int(config)), *size)
    scene, static = compile_scene(desc, device=dev, megakernel=False)
    spec = sampler_spec(static, dev)
    px, py = pixel_grid(static, dev)
    records = check_draws(spec, px, py, sample, static.max_depth, static.num_lights > 0)
    for r in records:
        print(f"[sampler_check] config {config} {r['name']} ({r['draw']}): {r['ms']:.4f} ms "
              f"(bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.3f}); differ "
              f"{dict((k, v) for k, v in r['differ'].items() if v)}")
    out = summary(records)
    out.update(config=config, kind=spec.kind, n=spec.effective_sample_count,
               width=static.width, height=static.height, records=records)
    if route:
        out.update(route_pass(scene, static))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="4", help="1, 2 or 4")
    parser.add_argument("--size", default="1920x1080", help="WxH of the lanes")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--json", default=None)
    args = parser.parse_args()
    result = main(args.config, tuple(int(x) for x in args.size.split("x")), args.device)
    print(json.dumps({k: v for k, v in result.items() if k != "records"}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
