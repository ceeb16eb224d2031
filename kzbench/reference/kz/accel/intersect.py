"""Ray and hit records and the Möller-Trumbore test (mesh.cpp:55-92).

The (t, u, v) conventions are the reference's: hit = (1-u-v)p0 + u p1 +
v p2. The trace kernels (accel/cluster_trace.py) and the shade prep use the
same formula, so the kernel, its plain version and the JAX package agree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_DET_EPS = 1e-8


class Rays(NamedTuple):
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    mint: torch.Tensor  # (N,)
    maxt: torch.Tensor  # (N,)


class Hit(NamedTuple):
    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,)
    face: torch.Tensor  # (N,) int64 global face id (undefined if !valid)
    u: torch.Tensor  # (N,) barycentric u
    v: torch.Tensor  # (N,) barycentric v


def moller_trumbore_edges(o, d, p0, e1, e2):
    """Möller-Trumbore with precomputed edges e1 = p1 - p0, e2 = p2 - p0, on
    broadcastable (..., 3) tensors. Returns (t, u, v, ok); ok ignores the
    ray's [mint, maxt] interval."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    px, py, pz = p0.unbind(-1)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > _DET_EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvx = ox - px
    tvy = oy - py
    tvz = oz - pz
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def moller_trumbore(o, d, p0, p1, p2):
    """Batched Möller-Trumbore on broadcastable (..., 3) tensors."""
    return moller_trumbore_edges(o, d, p0, p1 - p0, p2 - p0)
