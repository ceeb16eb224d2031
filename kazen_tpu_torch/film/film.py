"""Film: filtered splat accumulation (block.cpp:56-96).

The port of ``kazen_tpu/film/film.py``: the film is one (H, W, 4) buffer
(RGB + filter weight). ``splat_grid`` serves the full-pixel-grid lane layout
(one lane per pixel, row-major), where every filter-footprint offset is a 2D
shift + add; ``splat`` takes samples at any image positions (the
lane-chunked pass) and adds them with ``index_add_``, whose additions on
CUDA land in no fixed order, so a chunked film may differ from the grid
splat, and from itself between runs, in the last bits. Invalid (NaN or
negative) radiance is dropped (block.cpp:57-61). Filters are evaluated
analytically (rfilter.cpp:10-102): gaussian, mitchell, tent, box.
"""
from __future__ import annotations

import math as pymath

import numpy as np
import torch

from ..core import math as km
from ..utils import metrics


def filter_radius(static) -> float:
    """Per-kind radius: tent and box hard-code theirs (rfilter.cpp:77, 93)."""
    kind = static.rfilter_kind
    if kind == "tent":
        return 1.0
    if kind == "box":
        return 0.5
    return static.rfilter_radius


def filter_eval(static, x):
    """Filter value at offset x; zero outside the radius."""
    kind = static.rfilter_kind
    r = filter_radius(static)
    ax = torch.abs(x)
    if kind == "gaussian":
        alpha = -1.0 / (2.0 * static.rfilter_stddev**2)
        val = torch.clamp(torch.exp(alpha * ax * ax) - pymath.exp(alpha * r * r), min=0.0)
    elif kind == "mitchell":
        b, c = static.rfilter_b, static.rfilter_c
        x2 = 2.0 * ax / r
        x2sq = x2 * x2
        inner = (
            (12.0 - 9.0 * b - 6.0 * c) * x2 * x2sq
            + (-18.0 + 12.0 * b + 6.0 * c) * x2sq
            + (6.0 - 2.0 * b)
        ) * (1.0 / 6.0)
        outer = (
            (-b - 6.0 * c) * x2 * x2sq
            + (6.0 * b + 30.0 * c) * x2sq
            + (-12.0 * b - 48.0 * c) * x2
            + (8.0 * b + 24.0 * c)
        ) * (1.0 / 6.0)
        val = torch.where(x2 < 1.0, inner, torch.where(x2 < 2.0, outer, 0.0))
    elif kind == "tent":
        val = torch.clamp(1.0 - ax, min=0.0)
    elif kind == "box":
        val = torch.ones_like(ax)
    else:
        raise ValueError(f"unknown rfilter {kind}")
    return torch.where(ax <= r, val, 0.0)


def make_film(static, device) -> torch.Tensor:
    return torch.zeros((static.height, static.width, 4), device=device)


@metrics.traced("splat")
def splat(static, film, pixel_sample, value) -> torch.Tensor:
    """Accumulate one batch of samples at continuous image positions
    (block.cpp:56-85) into ``film`` (updated in place and returned).
    pixel_sample: (N, 2); value: (N, 3). Samples whose footprint lies off
    the image add weight 0 (the lane-chunked pass's padding lanes)."""
    ok = (torch.isfinite(value) & (value >= 0.0)).all(dim=-1)
    value = torch.where(ok[:, None], value, 0.0)
    r = filter_radius(static)
    # footprint: pixels with |centre - (sample - 0.5)| < r
    k = int(np.floor(2 * r)) + 2
    px = pixel_sample[:, 0] - 0.5
    py = pixel_sample[:, 1] - 0.5
    x0 = torch.ceil(px - r).to(torch.int64)
    y0 = torch.ceil(py - r).to(torch.int64)
    contrib = torch.cat([value, torch.ones_like(value[:, :1])], -1)
    film_flat = film.view(-1, 4)
    for dy in range(k):
        ys = y0 + dy
        wy = filter_eval(static, ys.to(torch.float32) - py)
        wy = torch.where((ys >= 0) & (ys < static.height), wy, 0.0)
        yi = torch.clamp(ys, 0, static.height - 1)
        for dx in range(k):
            xs = x0 + dx
            wx = filter_eval(static, xs.to(torch.float32) - px)
            wx = torch.where((xs >= 0) & (xs < static.width), wx, 0.0)
            xi = torch.clamp(xs, 0, static.width - 1)
            film_flat.index_add_(0, yi * static.width + xi, contrib * (wx * wy)[:, None])
    return film


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


@metrics.traced("splat")
def splat_grid(static, film, jitter, value) -> torch.Tensor:
    """Accumulate one sample per pixel into ``film`` (updated in place and
    returned). jitter: (N, 2) sub-pixel positions in [0,1); value: (N, 3)."""
    _splat_rows(static, film, 0, jitter, value)
    return film


def band_border(static) -> int:
    """Border rows of a splat band (the largest filter-footprint shift)."""
    r = filter_radius(static)
    return max(int(np.floor(r + 0.5)), -int(np.ceil(-(r + 0.5))))


def splat_grid_band(static, jitter, value) -> torch.Tensor:
    """splat_grid for a contiguous row band of the pixel grid (lanes = a
    whole number of rows in row-major order): the (rows + 2B, W, 4) band
    accumulation with B border rows above and below, which
    ``accumulate_band`` adds into the film at the band's row offset. The
    border rows carry the footprint that spills into the neighbouring
    bands, so the bands of a frame add up to splat_grid over the grid."""
    b = band_border(static)
    rows = value.shape[0] // static.width
    band = torch.zeros((rows + 2 * b, static.width, 4), dtype=value.dtype, device=value.device)
    _splat_rows(static, band, b, jitter, value)
    return band


def accumulate_band(static, film, band, row0: int) -> torch.Tensor:
    """Add a splat band (from splat_grid_band) into ``film`` (in place, and
    returned) at rows [row0 - B, row0 + rows + B), clipped to the image."""
    b = band_border(static)
    y0 = row0 - b
    lo = max(0, -y0)
    hi = band.shape[0] - max(0, y0 + band.shape[0] - static.height)
    film[y0 + lo: y0 + hi] += band[lo:hi]
    return film


def to_bitmap(film) -> torch.Tensor:
    """Divide the accumulated RGB by the filter weight (block.cpp:39-45)."""
    w = film[..., 3:4]
    return torch.where(w > 0.0, film[..., :3] / torch.clamp(w, min=1e-9), 0.0)


def to_srgb8(img) -> np.ndarray:
    img = torch.as_tensor(img)
    srgb = torch.clamp(km.to_srgb(torch.clamp(img, 0.0, 1.0)) * 255.0 + 0.5, 0, 255)
    return srgb.cpu().numpy().astype(np.uint8)

