"""``square_to_uniform_disk`` (warp.cpp), a frozen copy of the port's
``core/warp.py``'s, for the thin lens's aperture."""
from __future__ import annotations

import math as pymath

import torch


def square_to_uniform_disk(s):
    r = torch.sqrt(s[..., 0])
    phi = 2.0 * pymath.pi * s[..., 1]
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r], dim=-1)
