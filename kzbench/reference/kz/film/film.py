"""Film: filtered splat accumulation (block.cpp:56-96).

A frozen copy of the port's film, with the box filter only: the film is
one (H, W, 4) buffer (RGB + filter weight). ``splat_grid`` serves the
full-pixel-grid lane layout (one lane per pixel, row-major), where every
filter-footprint offset is a 2D shift + add. Invalid (NaN or negative)
radiance is dropped (block.cpp:57-61).
"""
from __future__ import annotations

import numpy as np
import torch



def filter_radius(static) -> float:
    """The box filter's radius, which it hard-codes (rfilter.cpp:93)."""
    if static.rfilter_kind != "box":
        raise ValueError(f"the reference has the box filter only, not {static.rfilter_kind}")
    return 0.5


def filter_eval(static, x):
    """The box filter's value at offset x: one within its radius, else
    zero (rfilter.cpp:87-102)."""
    r = filter_radius(static)
    return torch.where(torch.abs(x) <= r, 1.0, 0.0)


def make_film(static, device) -> torch.Tensor:
    return torch.zeros((static.height, static.width, 4), device=device)


def _add_shifted(out, a, dy: int, dx: int) -> None:
    """out[y+dy, x+dx] += a[y, x] where both lie in ``out`` (in place); out
    has a's width and at least its rows."""
    h, w = a.shape[:2]
    y_lo, y_hi = max(0, dy), min(out.shape[0], h + dy)
    out[y_lo:y_hi, max(0, dx): w + min(0, dx)] += a[
        y_lo - dy: y_hi - dy, max(0, -dx): w + min(0, -dx)
    ]


def _splat_rows(static, out, row0: int, jitter, value) -> None:
    """Add the filtered samples of lanes that are whole pixel rows in
    row-major order into ``out`` (in place), whose row ``row0`` is the
    lanes' first row; footprint rows beyond ``out`` are dropped."""
    w = static.width
    rows = value.shape[0] // w
    ok = (torch.isfinite(value) & (value >= 0.0)).all(dim=-1)
    value = torch.where(ok[:, None], value, 0.0)
    contrib = torch.cat([value, torch.ones_like(value[:, :1])], -1).reshape(rows, w, 4)
    # px - x = jitter - 0.5 for every lane
    jx = (jitter[:, 0] - 0.5).reshape(rows, w)
    jy = (jitter[:, 1] - 0.5).reshape(rows, w)
    r = filter_radius(static)
    d_lo = int(np.ceil(-(r + 0.5)))
    d_hi = int(np.floor(r + 0.5))
    for dy in range(d_lo, d_hi + 1):
        wy = filter_eval(static, dy - jy)
        for dx in range(d_lo, d_hi + 1):
            wx = filter_eval(static, dx - jx)
            _add_shifted(out, contrib * (wx * wy)[..., None], row0 + dy, dx)


def splat_grid(static, film, jitter, value) -> torch.Tensor:
    """Accumulate one sample per pixel into ``film`` (updated in place and
    returned). jitter: (N, 2) sub-pixel positions in [0,1); value: (N, 3)."""
    _splat_rows(static, film, 0, jitter, value)
    return film


def to_bitmap(film) -> torch.Tensor:
    """Divide the accumulated RGB by the filter weight (block.cpp:39-45)."""
    w = film[..., 3:4]
    return torch.where(w > 0.0, film[..., :3] / torch.clamp(w, min=1e-9), 0.0)

