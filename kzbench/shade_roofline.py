"""The shade kernel's (K7, ``shade/csrc/bounce.cu``) bytes bound.

A launch shades N lanes, one thread a lane. Each lane reads once K1's rows
3-33 (31 float32), its ray origin and direction, radiance and throughput
(12), its eta, BSDF pdf and accumulated roughness (3), its alive and
discrete flags (1 byte each), the bounce's uniforms it consumes (s1 and s2,
4 for NEE where the scene has lights, 1 for Russian roulette where drawn)
and, where some material field is image-textured, the footprint columns
(lod, and the major uv half-axis with anisotropy); it writes 24 float32 and
two int64. The launch also reads its tables and the texel pool, counted
once: a lane's texture probes hit the cache, so the count is a floor on the
bytes, and the bound (bytes over 3.35 TB/s, kzbench/roofline.py's peak) a
floor on the time.
"""
from __future__ import annotations

import dataclasses

import torch

from .roofline import PEAK_BYTES_PER_S

ROWS_READ = 31
STATE_FLOATS = 3 * 4 + 3
OUT_FLOATS, OUT_INT64 = 24, 2


def lane_bytes(n_strat: int, draw_rr: bool, footprint: int) -> int:
    """Bytes one lane reads and writes once (``footprint``: 0, 1 or 3
    columns)."""
    uniforms = 3 + (4 if n_strat > 0 else 0) + (1 if draw_rr else 0)
    read = 4 * (ROWS_READ + STATE_FLOATS + uniforms + footprint) + 2
    return read + 4 * OUT_FLOATS + 8 * OUT_INT64


def table_bytes(tables, texels=None) -> int:
    """The bytes of a launch's packed tables (every tensor field) and texel
    pool."""
    total = sum(t.numel() * t.element_size() for t in
                (getattr(tables, f.name) for f in dataclasses.fields(tables))
                if isinstance(t, torch.Tensor))
    if texels is not None:
        total += texels.numel() * texels.element_size()
    return total


def launch(args, kwargs) -> dict:
    """One launch's lanes, bytes and bound from the arguments of
    ``bounce_kernel.shade_cuda(tables, static, rows, ray_o, ..., draws,
    texels=..., footprint=...)``."""
    tables, static, ray_o, draws = args[0], args[1], args[3], args[12]
    lod, aniso = kwargs.get("footprint", (None, None))
    footprint = 0 if lod is None else (1 if aniso is None else 3)
    n = int(ray_o.shape[0])
    n_strat = int(static.num_lights) if draws.u_pick is not None else 0
    total = n * lane_bytes(n_strat, draws.u_rr is not None, footprint) + table_bytes(
        tables, kwargs.get("texels"))
    return {"n": n, "bytes": total, "bound_s": total / PEAK_BYTES_PER_S}
