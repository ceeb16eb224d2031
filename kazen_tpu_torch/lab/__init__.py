"""The lab probes K4-K6: the ports of ``benchmarks/mxu_lab.py`` and
``benchmarks/visit_lab.py``, the cost probes of the cluster-trace kernel's
pieces. They are not on a path of ``render()``.

* ``mxu_lab``: K4, the repeated matrix product (``mm_probe``), and K5, the
  Moller-Trumbore acceptance chain (``chain_probe``);
* ``visit_lab``: K6, the simulated leaf visits (``make_drain``).

Measuring scripts sit beside them: ``profile_pass2`` (the stage
attribution of a render pass, the port of ``benchmarks/profile_pass2.py``)
and ``glue_lab`` (the micro-costs of the PyTorch glue, the port of
``benchmarks/xla_lab.py``), which have no kernel of their own.

The three kernels live in one source, ``csrc/lab.cu``, built by
``cuda_build.build_library`` into one ctypes library. Each wrapper launches
its kernel for CUDA tensors and takes its plain PyTorch version for CPU
tensors. ``python -m kazen_tpu_torch.lab.mxu_lab`` and
``python -m kazen_tpu_torch.lab.visit_lab`` run the probes' tables.
"""
from __future__ import annotations

import bisect
import ctypes
import functools
import os
import time

import torch

from .. import cuda_build
from ..cuda_build import CudaKernel

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "lab.cu")
RANGE = "profiled range"  # the name of profile_ranges' ranges
# tiny launches that open a profiled session on the card, outside every
# range: in a process that has profiled before, the profiler was seen to
# lose up to a few dozen of a session's first device activities
PROFILE_WARMUP = 64


def build_library() -> "tuple[str, str]":
    """Compile csrc/lab.cu for sm_90a into the build directory (once per
    source hash). Returns (library path, compiler output)."""
    return cuda_build.build_library(SOURCE, "libkazen_lab")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kz_mm_probe.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.kz_mm_probe.restype = i
    lib.kz_chain_probe.argtypes = [p, p, p, p, i, i, p]
    lib.kz_chain_probe.restype = i
    lib.kz_chain_empty.argtypes = [i, p]
    lib.kz_chain_empty.restype = i
    lib.kz_drain_probe.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.kz_drain_probe.restype = i
    lib.kz_error_string.argtypes = [i]
    lib.kz_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(code: int, kernel: CudaKernel) -> None:
    if code != 0:
        msg = library().kz_error_string(code).decode()
        raise RuntimeError(f"{kernel.name} launch failed: {msg} ({code})")


def timed(fn, device: torch.device, calls: int) -> float:
    """ms per call of ``fn`` over ``calls`` calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3 / calls


def profile_ranges(fns, device: torch.device, **profile_args):
    """Each of ``fns`` called once under one torch.profiler session, in a
    ``record_function`` range of its own (on the card the device is
    synchronized at the range's end), after PROFILE_WARMUP tiny launches on
    the card. Returns (the session's raw events, [(start ns, end ns)] of
    each range on the host, [each call's result]); the raw events are read
    as they are (parsing them into FunctionEvents takes seconds a pass)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    results = []
    with profile(activities=activities, **profile_args) as prof:
        if cuda:
            warm = torch.zeros(PROFILE_WARMUP, device=device)
            for k in range(PROFILE_WARMUP):
                warm[k:k + 1].add_(1.0)
            torch.cuda.synchronize(device)
        for k, fn in enumerate(fns):
            with record_function(f"{RANGE} {k}"):
                results.append(fn())
                if cuda:
                    torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    # a range is recorded twice: on the host, and as the device's time
    # under it; the host's holds the launches
    spans = {int(e.name().split()[-1]): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if e.name().startswith(RANGE)
             and e.device_type() == torch.autograd.DeviceType.CPU}
    return events, [spans[k] for k in range(len(fns))], results


def device_activities(events) -> list:
    """The device's activities (kernels, copies, fills) among ``events``."""
    return [e for e in events if e.device_type() != torch.autograd.DeviceType.CPU
            and e.duration_ns() > 0 and not e.name().startswith(RANGE)]


def range_activities(events, ranges) -> list:
    """The device activities launched inside each of the disjoint, ordered
    host ``ranges``, by the host time of the CUDA runtime call that launched
    each: [[event, ...] a range]."""
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith("cu")}
    starts = [r[0] for r in ranges]
    out = [[] for _ in ranges]
    for e in device_activities(events):
        ts = launched.get(e.correlation_id())
        k = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        if k >= 0 and ts <= ranges[k][1]:
            out[k].append(e)
    return out


def table_times(rows, device: torch.device, runs: int = 3) -> list:
    """Times of a probe table's rows, each a (name, fn): ``ms``, the mean of
    ``runs`` calls after a warm-up (CUDA events on the card, the host clock
    on the CPU); on the card also ``device_ms`` and ``launches``, the time
    and count of the device activities one call of the row launched, from
    one profiled session over all rows. Both None on the CPU."""
    out = [{"name": name, "ms": timed(fn, device, runs), "device_ms": None, "launches": None}
           for name, fn in rows]
    if device.type == "cuda":
        events, ranges, _ = profile_ranges([fn for _, fn in rows], device)
        for r, acts in zip(out, range_activities(events, ranges)):
            r["device_ms"] = sum(e.duration_ns() for e in acts) / 1e6
            r["launches"] = len(acts)
    return out


def launch_device_ms(fn, launches: int, sessions: int = 3) -> float:
    """The median device time (ms) of one launch: ``fn`` (one kernel launch
    on the card) called ``launches`` times after a warm-up call, in a
    profiled session; a session that did not deliver every launch's record
    is run again, up to ``sessions`` in all."""
    fn()
    device = torch.device("cuda", torch.cuda.current_device())
    for _ in range(sessions):
        events, ranges, _ = profile_ranges([lambda: [fn() for _ in range(launches)]], device)
        times = sorted(e.duration_ns() / 1e6 for e in range_activities(events, ranges)[0])
        if len(times) == launches:
            return times[launches // 2]
    raise RuntimeError(f"{launches} launches, {len(times)} device activities profiled")


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
