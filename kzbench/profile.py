"""The traced window: torch.profiler over a few steady units of work (render
passes), with spans the benchmark puts around the program's calls.

A span is a ``record_function`` range named ``kzbench:<stage>`` around a
function of the program, installed by replacing the module attribute the
program looks the function up by, and removed when the window closes. Each
device activity (kernel, copy, fill) is traced, through the CUDA runtime
call that shares its correlation id, to the innermost span open on the host
when that call ran; activities launched outside every span go to ``other``.
The raw events are read as they are (``kineto_results.events()``: parsing
them into FunctionEvents takes seconds a pass), and nothing is written to
disk.
"""
from __future__ import annotations

import bisect
import functools
import re
import time
from dataclasses import dataclass, field

import torch

SPAN = "kzbench:"
WINDOW = SPAN + "window"
OTHER = "other"


@dataclass
class Activity:
    name: str
    start_ns: int
    dur_ns: int
    stage: str


@dataclass
class Records:
    """What a traced window recorded; the metric readers take it."""

    units: int  # render passes (or steps) in the window
    window_s: float  # host seconds from the window's first sync to its last
    busy_s: float  # seconds in which a device activity ran
    activities: list  # [Activity]
    launches: dict = field(default_factory=dict)  # captured launches by kernel tag
    extra: dict = field(default_factory=dict)


def span_wrapper(fn, stage: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(SPAN + stage):
            return fn(*args, **kwargs)

    return wrapped


def kernel_base(name: str) -> str:
    """A device activity's name without return type, namespaces and
    template arguments: ``void at::native::elementwise_kernel<128, ...>(...)``
    is ``elementwise_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"[<(].*", "", name.replace("void ", "", 1)).split("::")[-1].strip()
    return base or name[:60]


class Session:
    """One profiled window. ``patches`` is [(module, attribute, wrapper
    factory)]: while the window is open, ``module.attribute`` is
    ``factory(original)``."""

    def __init__(self, device: torch.device, patches):
        self.device = device
        self.patches = patches
        self._saved = []
        self._prof = None
        self._window = None
        self.events = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        for mod, attr, factory in self.patches:
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, factory(orig))
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self._window.__exit__(None, None, None)
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []
        self._prof.__exit__(None, None, None)
        self.events = self._prof.profiler.kineto_results.events()

    def records(self, units: int) -> Records:
        return reduce_events(self.events, units, self.t1 - self.t0)


def reduce_events(events, units: int, host_window_s: float) -> Records:
    """Records of a window from the profiler's raw events."""
    cpu = torch.autograd.DeviceType.CPU
    spans, launched, window = [], {}, None
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == cpu:
            if name == WINDOW:
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name.startswith(SPAN):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[len(SPAN):]))
            elif name.startswith("cu"):
                launched[e.correlation_id()] = e.start_ns()
        elif e.duration_ns() > 0 and not name.startswith(SPAN):
            device.append(e)
    points, stages = _innermost(spans)
    acts = []
    for e in device:
        ts = launched.get(e.correlation_id())
        stage = OTHER
        if ts is not None:
            k = bisect.bisect_right(points, ts) - 1
            if k >= 0:
                stage = stages[k]
        acts.append(Activity(e.name(), e.start_ns(), e.duration_ns(), stage))
    acts.sort(key=lambda a: a.start_ns)
    lo, hi = window if window is not None else (None, None)
    busy = _union_ns(acts, lo, hi) / 1e9
    window_s = (hi - lo) / 1e9 if window is not None else host_window_s
    return Records(units=units, window_s=window_s, busy_s=busy, activities=acts)


def _innermost(spans):
    """Boundary times and the innermost span's stage from each boundary on
    (``OTHER`` where no span is open), for properly nested spans."""
    marks = []
    for s, e, stage in spans:
        marks.append((s, 1, stage))
        marks.append((e, 0, stage))
    marks.sort(key=lambda m: (m[0], m[1]))
    stack, points, stages = [], [], []
    for t, is_start, stage in marks:
        if is_start:
            stack.append(stage)
        elif stage in stack:
            # the last open span of this stage closes
            idx = len(stack) - 1 - stack[::-1].index(stage)
            stack.pop(idx)
        points.append(t)
        stages.append(stack[-1] if stack else OTHER)
    return points, stages


def _union_ns(acts, lo=None, hi=None) -> int:
    total, cur_s, cur_e = 0, None, None
    for a in acts:
        s, e = a.start_ns, a.start_ns + a.dur_ns
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def breakdown(rec: Records, top: int = 10) -> dict:
    """The device operations that took most time, by the stage that launched
    them and the kernel's base name, and the longest idle gaps of the device,
    each named by the stage that launched the activity the device waited
    for and that activity's base name."""
    by_name = {}
    for a in rec.activities:
        key = f"{a.stage}: {kernel_base(a.name)}"
        by_name[key] = by_name.get(key, 0) + a.dur_ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for a in rec.activities:
        if end is not None and a.start_ns > end:
            gaps.append((f"{a.stage} -> {kernel_base(a.name)}", (a.start_ns - end) / 1e9))
        end = a.start_ns + a.dur_ns if end is None else max(end, a.start_ns + a.dur_ns)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
