"""Observability: per-pass render metrics and an ETA progress line (the
reference's progress stack, SURVEY §5).

The port of the parts of ``kazen_tpu/utils/metrics.py`` that render() uses
(``metrics``, ``verbose``): each pass reports its seconds and rays traced,
hence rays/s and pixel-samples/s.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import List


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
