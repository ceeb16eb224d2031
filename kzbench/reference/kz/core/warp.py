"""Square-to-distribution warps and their pdfs (warp.cpp:7-130), batched.
Sample arguments are (..., 2) uniforms in [0,1)."""
from __future__ import annotations

import math as pymath

import torch

from .math import vec3


def square_to_cosine_hemisphere(s):
    """Concentric-disk (Cline) mapping + lift (warp.cpp:86-115)."""
    r1 = 2.0 * s[..., 0] - 1.0
    r2 = 2.0 * s[..., 1] - 1.0
    use_r1 = r1 * r1 > r2 * r2
    r = torch.where(use_r1, r1, r2)
    safe_r1 = torch.where(r1 == 0.0, 1.0, r1)
    safe_r2 = torch.where(r2 == 0.0, 1.0, r2)
    phi = torch.where(
        use_r1,
        (pymath.pi / 4.0) * (r2 / safe_r1),
        (pymath.pi / 2.0) - (r1 / safe_r2) * (pymath.pi / 4.0),
    )
    degen = (r1 == 0.0) & (r2 == 0.0)
    r = torch.where(degen, 0.0, r)
    phi = torch.where(degen, 0.0, phi)
    px = r * torch.cos(phi)
    py = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    z = torch.where(z == 0.0, 1e-10, z)
    return vec3(px, py, z)

