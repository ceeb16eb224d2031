"""Observability: the tracer (spans, the host-read counter, per-pass CUDA
events), per-pass render metrics, an ETA progress line, log lines and a
timer (the reference's Timer/LOG/progress stack, SURVEY §5).

The tracer is off by default and switched by ``tracing(on)``. Off, a span
or a host-read site costs one test of the module flag ``_on`` and returns
the shared null context: no clock, no ``record_function``, no CUDA event,
no record. On, each span records its name, start and end (ns on
torch.profiler's clock, Unix time: ``perf_counter_ns`` plus an offset taken
when tracing is switched on), its id, its parent's id, the id of the
``render()`` call or ``optimize()`` step it belongs to and a few
attributes. While torch.profiler runs, each span also opens a
``record_function`` range named ``kazen:<span name>``, so a device activity
can be put in its span by correlation id. A ``render.pass`` span on the
card records a CUDA event at its start and end; nothing waits on them until
``collect()``, which makes the one synchronize and returns the spans and
counters (host reads by site, material texture lookups by field and route,
bounces by shade route and the plain ones by reason, texture footprints
and sampler draws by route, CUDA kernel launches, rays traced) and clears
them. ``write_chrome_trace``
writes what ``collect()`` returned as a Chrome trace (the CLI's ``--trace
FILE``). The tracer keeps one record for the
process and is not thread-safe.

``RenderMetrics`` times each pass of a ``render(metrics=...)`` call with
the same pass spans (CUDA events on the card, the host clock on the CPU),
sums its rays on the device and synchronizes once, when the call ends.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List

import torch
from torch.autograd.profiler import record_function

PREFIX = "kazen:"  # the record_function ranges of the spans
CALLS = ("render.call", "optimize.step")  # spans that start a call id of their own
NULL = contextlib.nullcontext()

_on = False  # the tracer's switch: tracing()
_rec = None  # what the tracer recorded since the last collect(): a _Record


class Span:
    """One span; times in ns on torch.profiler's clock (Unix time).
    ``device_ms`` is the device-clock time between its CUDA events (a
    ``render.pass`` on the card), filled in by ``collect()``."""

    __slots__ = ("name", "id", "parent", "call", "attrs", "start_ns", "end_ns", "device_ms",
                 "_events")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.call = None
        self.start_ns = self.end_ns = 0
        self.device_ms = None
        self._events = None

    def begin(self, device, offset_ns: int) -> None:
        if device is not None and device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = time.perf_counter_ns() + offset_ns

    def end(self, offset_ns: int) -> None:
        self.end_ns = time.perf_counter_ns() + offset_ns
        if self._events is not None:
            self._events[1].record()

    def resolve(self) -> None:
        """The device-clock ms between the span's events (after a sync)."""
        if self._events is not None:
            self.device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Record:
    """What the tracer recorded: the open spans' stack and, since tracing
    began or the last collect(), the closed spans, the host reads by site,
    the texture lookups by field and route, the bounces by shade route and
    the plain ones by reason, the sampler draws by route, the texture
    footprints, environment NEE and Beckmann lobes by route, the ray
    tensors and the kernels' launch counts at the start."""

    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.ids = itertools.count(1)
        self.stack: List[Span] = []
        self.spans: List[Span] = []
        self.host_reads = {}
        self.texture_lookups = {}
        self.shade_route = {}
        self.shade_plain_reason = {}
        self.sampler_route = {}
        self.texture_footprint = {}
        self.env_nee = {}
        self.beckmann_lobes = {}
        self.rays = []
        self.launches0 = _launch_counts()


class _Open:
    """An open span of the tracer (the context ``span`` returns when on)."""

    __slots__ = ("span", "device", "rec", "_range")

    def __init__(self, name, attrs, device):
        self.span, self.device, self.rec, self._range = Span(name, attrs), device, _rec, None

    def __enter__(self) -> Span:
        rec, s = self.rec, self.span
        parent = rec.stack[-1] if rec.stack else None
        s.id = next(rec.ids)
        s.parent = parent.id if parent is not None else None
        s.call = s.id if parent is None or s.name in CALLS else parent.call
        rec.stack.append(s)
        # the clock before the range: a range's first opening in a process
        # returns a millisecond after the profiler stamped it
        s.begin(self.device, rec.offset_ns)
        if torch.autograd._profiler_enabled():
            self._range = record_function(PREFIX + s.name)
            self._range.__enter__()
        return s

    def __exit__(self, *exc):
        rec, s = self.rec, self.span
        s.end(rec.offset_ns)
        if self._range is not None:
            self._range.__exit__(*exc)
        rec.stack.remove(s)
        rec.spans.append(s)
        return False


def _launch_counts() -> dict:
    from ..cuda_build import KERNELS

    return {k.name: k.launches for k in KERNELS}


class tracing:
    """Switch the tracer on (``tracing()``, ``tracing(True)``) or off
    (``tracing(False)``) now. Used as a context manager, it puts the switch
    back as it was when the block ends. Switching on starts a record when
    there is none; switching off keeps what was recorded for ``collect()``."""

    def __init__(self, on: bool = True):
        global _on, _rec
        self.was = _on
        if on and _rec is None:
            _rec = _Record()
        _on = bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        tracing(self.was)
        return False


def span(name: str, key: str = None, value=None, device=None):
    """A span named ``name`` around a block, with the attribute ``key`` =
    ``value`` where given. ``device`` (a CUDA device) adds the CUDA events
    of a pass. Off, the shared null context."""
    if not _on:
        return NULL
    return _Open(name, {} if key is None else {key: value}, device)


def traced(name: str):
    """A decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name, {}, None):
                return fn(*args, **kwargs)
        return wrapped
    return wrap


def sync(site: str, reads: bool = True):
    """A ``sync`` span around a place where the host reads a device value or
    copies a host value onto the card (``site``: file, function and what it
    reads); the ``host_reads`` counter of the site adds one. ``reads``
    False (the value is on the device already) makes it the null context.
    The CPU counts the same sites."""
    if not _on or not reads:
        return NULL
    _rec.host_reads[site] = _rec.host_reads.get(site, 0) + 1
    return _Open("sync", {"site": site}, None)


def texture_lookup(field: str, route: str) -> None:
    """Count one material texture lookup of ``field`` ("base", "metallic",
    "roughness", "normal") by its route: "constant" (no material textures
    the field: the row's constant, no fetch) or "image" (the texture graph,
    eval_texture), as shade/bsdf.py chose for it, or "kernel" (a shade
    kernel launch that fetched the field from its image, once a bounce)."""
    if _on:
        by_route = _rec.texture_lookups.setdefault(field, {"constant": 0, "image": 0})
        by_route[route] = by_route.get(route, 0) + 1


def shade_route(route: str, reason: str) -> None:
    """Count one bounce's shade stage by the route integrate/path_mis.py
    took: "kernel" (shade/bounce_kernel.py's CUDA kernel) or "plain"
    (path_mis._shade_plain); a plain bounce also by ``reason``, the words of
    bounce_kernel.route_reason (``shade_plain_reason``)."""
    if _on:
        _rec.shade_route[route] = _rec.shade_route.get(route, 0) + 1
        if route == "plain":
            _rec.shade_plain_reason[reason] = _rec.shade_plain_reason.get(reason, 0) + 1


def sampler_route(route: str) -> None:
    """Count one sampler draw by the route samplers/streams.py took:
    "kernel" (samplers/draw_kernel.py's CUDA kernel) or "plain" (the
    streams' plain PyTorch version)."""
    if _on:
        _rec.sampler_route[route] = _rec.sampler_route.get(route, 0) + 1


def texture_footprint(route: str) -> None:
    """Count one derivation of a bounce's texture footprint by route:
    "kernel" (a shade kernel launch that derived it in-kernel) or "plain"
    (a plain shade stage whose path_mis._texture_footprint returns one)."""
    if _on:
        _rec.texture_footprint[route] = _rec.texture_footprint.get(route, 0) + 1


def env_nee(route: str) -> None:
    """Count one bounce whose NEE samples the importance-sampled environment
    (a stratum of the light pick) by route: "kernel" (a shade kernel launch)
    or "plain" (a plain shade stage)."""
    if _on:
        _rec.env_nee[route] = _rec.env_nee.get(route, 0) + 1


def beckmann_lobes(route: str) -> None:
    """Count one bounce of a scene that holds a rough* (Beckmann) material
    by route: "kernel" (a shade kernel launch) or "plain" (a plain shade
    stage)."""
    if _on:
        _rec.beckmann_lobes[route] = _rec.beckmann_lobes.get(route, 0) + 1


def rays(nrays) -> None:
    """Keep a pass's ray count (a device tensor) for ``collect()``, which
    sums them once."""
    if _on:
        _rec.rays.append(nrays)


def collect() -> dict:
    """Everything recorded since tracing began or the last collect(), which
    is cleared: ``spans`` (closed spans, in the order they closed),
    ``host_reads`` ({site: count}), ``texture_lookups`` ({field: {route:
    count}}), ``shade_route``, ``sampler_route``, ``texture_footprint``,
    ``env_nee`` and ``beckmann_lobes`` ({route: count}),
    ``shade_plain_reason`` ({reason: count}),
    ``launches`` ({CUDA kernel: launches since}), ``rays`` (their sum). One
    synchronize where a span recorded CUDA events or a ray count lives on
    the card. Spans still open go to the next collect()."""
    global _rec
    rec = _rec
    if rec is None:
        return {"spans": [], "host_reads": {}, "texture_lookups": {}, "shade_route": {},
                "shade_plain_reason": {}, "sampler_route": {}, "texture_footprint": {},
                "env_nee": {}, "beckmann_lobes": {}, "launches": {}, "rays": 0.0}
    spans, rec.spans = rec.spans, []
    reads, rec.host_reads = rec.host_reads, {}
    lookups, rec.texture_lookups = rec.texture_lookups, {}
    routes, rec.shade_route = rec.shade_route, {}
    reasons, rec.shade_plain_reason = rec.shade_plain_reason, {}
    draws, rec.sampler_route = rec.sampler_route, {}
    footprints, rec.texture_footprint = rec.texture_footprint, {}
    env, rec.env_nee = rec.env_nee, {}
    beckmann, rec.beckmann_lobes = rec.beckmann_lobes, {}
    counts, rec.rays = rec.rays, []
    launches0, rec.launches0 = rec.launches0, _launch_counts()
    if not _on and not rec.stack:
        _rec = None
    if any(s._events is not None for s in spans) or any(r.is_cuda for r in counts):
        torch.cuda.synchronize()
    for s in spans:
        s.resolve()
    launches = {k: n - launches0.get(k, 0) for k, n in rec.launches0.items()
                if n != launches0.get(k, 0)}
    total = float(torch.stack([r.double() for r in counts]).sum()) if counts else 0.0
    return {"spans": spans, "host_reads": reads, "texture_lookups": lookups,
            "shade_route": routes, "shade_plain_reason": reasons, "sampler_route": draws,
            "texture_footprint": footprints, "env_nee": env, "beckmann_lobes": beckmann,
            "launches": launches, "rays": total}


def write_chrome_trace(path: str, collected: dict) -> None:
    """What ``collect()`` returned as a Chrome trace (``chrome://tracing``,
    Perfetto): one complete event a span, ``ts`` in microseconds of Unix
    time (torch.profiler's clock), the ids, attributes and device ms under
    ``args``; the counters under ``otherData``."""
    pid = os.getpid()
    events = []
    for s in collected["spans"]:
        args = dict(s.attrs, id=s.id, parent=s.parent, call=s.call)
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": 0,
                       "args": args})
    other = {"clock": "unix", "host_reads": collected["host_reads"],
             "texture_lookups": collected["texture_lookups"],
             "shade_route": collected["shade_route"],
             "shade_plain_reason": collected["shade_plain_reason"],
             "sampler_route": collected["sampler_route"],
             "texture_footprint": collected["texture_footprint"],
             "env_nee": collected["env_nee"], "beckmann_lobes": collected["beckmann_lobes"],
             "launches": collected["launches"], "rays": collected["rays"]}
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms", "otherData": other}, f,
                  default=repr)


@dataclass
class PassMetrics:
    sample_index: int
    seconds: float
    rays: float
    lanes: int

    @property
    def rays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-9)

    @property
    def pixel_samples_per_s(self) -> float:
        return self.lanes / max(self.seconds, 1e-9)


@dataclass
class RenderMetrics:
    """Each pass of a ``render(metrics=...)`` call: its seconds (device-clock
    time between the pass span's CUDA events on the card, the span's host
    time on the CPU) and rays, read when the call ends."""

    passes: List[PassMetrics] = field(default_factory=list)
    _pending: list = field(default_factory=list, init=False, repr=False)

    def add(self, m: PassMetrics):
        self.passes.append(m)

    @contextlib.contextmanager
    def pass_span(self, sample_index: int, lanes: int, device):
        """Time one pass; the pass's ray counts (device tensors) go into the
        list it yields."""
        s, counts = Span("render.pass", {"index": sample_index}), []
        s.begin(device, 0)
        yield counts
        s.end(0)
        self._pending.append((s, lanes, counts))

    def finish(self):
        """The call's passes as PassMetrics: one synchronize for them all."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        with sync("utils/metrics.py:RenderMetrics.finish"):
            totals = torch.stack([torch.stack(c).double().sum() for _, _, c in pending]).tolist()
        for (s, lanes, _), total in zip(pending, totals):
            s.resolve()
            seconds = s.device_ms / 1e3 if s.device_ms is not None else s.host_ms / 1e3
            self.add(PassMetrics(sample_index=s.attrs["index"], seconds=seconds, rays=total,
                                 lanes=lanes))

    def summary(self) -> dict:
        if not self.passes:
            return {}
        total_s = sum(p.seconds for p in self.passes)
        total_rays = sum(p.rays for p in self.passes)
        total_ps = sum(p.lanes for p in self.passes)
        return {
            "passes": len(self.passes),
            "seconds": total_s,
            "rays": total_rays,
            "rays_per_s": total_rays / max(total_s, 1e-9),
            "pixel_samples_per_s": total_ps / max(total_s, 1e-9),
        }


class Progress:
    """ETA progress line (progress.cpp:7-57), at most 10 updates a second."""

    def __init__(self, total: int, label: str = "render", stream=None):
        self.total = total
        self.label = label
        self.stream = stream if stream is not None else sys.stderr
        self.start = time.time()
        self._last = 0.0

    def update(self, done: int):
        now = time.time()
        if now - self._last < 0.1 and done < self.total:
            return
        self._last = now
        frac = done / max(self.total, 1)
        elapsed = now - self.start
        eta = elapsed / max(frac, 1e-9) * (1 - frac)
        bar = "=" * int(40 * frac) + " " * (40 - int(40 * frac))
        self.stream.write(
            f"\r[{self.label}] |{bar}| {done}/{self.total} "
            f"({elapsed:.1f}s, eta {eta:.1f}s)"
        )
        if done >= self.total:
            self.stream.write("\n")
        self.stream.flush()


def LOG(msg: str, stream=None):
    """Timestamped log line (the reference's LOG(), common.h:451-454)."""
    (stream if stream is not None else sys.stderr).write(
        f"[kazen-tpu {time.strftime('%H:%M:%S')}] {msg}\n"
    )


@contextlib.contextmanager
def timed(label: str, stream=None):
    """Timer (timer.h) with a LOG-style line: the host's wall clock around
    what runs inside."""
    t0 = time.time()
    yield
    (stream if stream is not None else sys.stderr).write(
        f"[kazen-tpu] {label}: {(time.time() - t0) * 1000:.1f} ms\n"
    )
