"""Square-to-distribution warps and their pdfs (warp.cpp:7-130), batched.
Sample arguments are (..., 2) uniforms in [0,1)."""
from __future__ import annotations

import math as pymath

import torch

from .math import INV_FOURPI, INV_PI, INV_TWOPI, vec3


def square_to_uniform_square(s):
    return s


def square_to_uniform_square_pdf(s):
    inside = ((s >= 0.0) & (s <= 1.0)).all(dim=-1)
    return inside.to(s.dtype)


def _interval_to_tent(s):
    sign = torch.where(s < 0.5, 1.0, -1.0)
    s2 = torch.where(s < 0.5, 2.0 * s, 2.0 * (s - 0.5))
    return sign * (1.0 - torch.sqrt(torch.clamp(s2, min=0.0)))


def square_to_tent(s):
    return torch.stack(
        [_interval_to_tent(s[..., 0]), _interval_to_tent(s[..., 1])], dim=-1
    )


def square_to_tent_pdf(p):
    return (1.0 - torch.abs(p[..., 0])) * (1.0 - torch.abs(p[..., 1]))


def square_to_uniform_disk(s):
    r = torch.sqrt(s[..., 0])
    phi = 2.0 * pymath.pi * s[..., 1]
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r], dim=-1)


def square_to_uniform_disk_pdf(p):
    return torch.full(p.shape[:-1], INV_PI, dtype=p.dtype, device=p.device)


def square_to_uniform_sphere(s):
    z = 1.0 - 2.0 * s[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * pymath.pi * s[..., 0]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_uniform_sphere_pdf(v):
    return torch.full(v.shape[:-1], INV_FOURPI, dtype=v.dtype, device=v.device)


def square_to_uniform_hemisphere(s):
    z = s[..., 0]
    tmp = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * pymath.pi * s[..., 1]
    return vec3(torch.cos(phi) * tmp, torch.sin(phi) * tmp, z)


def square_to_uniform_hemisphere_pdf(v):
    return torch.full(v.shape[:-1], INV_TWOPI, dtype=v.dtype, device=v.device)


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


def square_to_cosine_hemisphere_pdf(v):
    return INV_PI * v[..., 2]


def square_to_beckmann(s, alpha):
    """Beckmann microfacet normal (warp.cpp:118-127)."""
    phi = 2.0 * pymath.pi * s[..., 0]
    theta = torch.atan(
        alpha * torch.sqrt(torch.log(1.0 / torch.clamp(1.0 - s[..., 1], min=1e-9)))
    )
    st, ct = torch.sin(theta), torch.cos(theta)
    return vec3(st * torch.cos(phi), st * torch.sin(phi), ct)


def square_to_beckmann_pdf(m, alpha):
    ct = torch.clamp(m[..., 2], -1.0, 1.0)
    tan2 = torch.clamp(1.0 - ct * ct, min=0.0) / torch.clamp(ct * ct, min=1e-9)
    pdf = torch.exp(-tan2 / (alpha * alpha)) / (
        pymath.pi * alpha * alpha * torch.clamp(ct, min=1e-9) ** 3
    )
    return torch.where(ct > 0.0, pdf, 0.0)
