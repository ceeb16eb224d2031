"""The film's reconstruction filters (frozen copies of the port's
``film/film.py`` ``filter_radius`` and ``filter_eval``, cut to the box
and gaussian kinds, rfilter.cpp:10-102)."""
from __future__ import annotations

import math as pymath

import torch


def filter_radius(static) -> float:
    """Per-kind radius: the box hard-codes its own (rfilter.cpp:93)."""
    kind = static.rfilter_kind
    if kind not in ("box", "gaussian"):
        raise ValueError(f"the reference has the box and gaussian filters only, not {kind}")
    return 0.5 if kind == "box" else static.rfilter_radius


def filter_eval(static, x):
    """Filter value at offset x; zero outside the radius."""
    r = filter_radius(static)
    ax = torch.abs(x)
    if static.rfilter_kind == "gaussian":
        alpha = -1.0 / (2.0 * static.rfilter_stddev**2)
        val = torch.clamp(torch.exp(alpha * ax * ax) - pymath.exp(alpha * r * r), min=0.0)
    else:
        val = torch.ones_like(ax)
    return torch.where(ax <= r, val, 0.0)
