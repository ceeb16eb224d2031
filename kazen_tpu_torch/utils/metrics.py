"""Observability: per-pass render metrics, an ETA progress line, log lines,
a timer and profiler tracing (the reference's Timer/LOG/progress stack,
SURVEY §5).

The port of ``kazen_tpu/utils/metrics.py``: each pass reports its seconds
and rays traced, hence rays/s and pixel-samples/s; ``profiler_trace`` wraps
torch.profiler where the reference wraps jax.profiler. The streams default
to sys.stderr as it is when a line is written.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional


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
    passes: List[PassMetrics] = field(default_factory=list)

    def add(self, m: PassMetrics):
        self.passes.append(m)

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


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Trace what runs inside under torch.profiler (the host and, where
    there is one, the card) and write a Chrome trace to
    ``log_dir/trace.json``; nothing when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
