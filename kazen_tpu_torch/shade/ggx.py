"""Microfacet math on local-frame direction batches (..., 3): GGX-Smith
(ggx_brdf.h, after Heitz 2014/2018) for kiss and ggx, and the Beckmann
pieces of the rough* models (bsdf.cpp:717-757). The port of
``kazen_tpu/shade/ggx.py``."""
from __future__ import annotations

import math as pymath

import torch

from ..core import math as km
from ..utils import metrics

MIN_ALPHA = 1e-3


def schlick_fresnel(f0, cos_theta):
    """evaluateSchlickFresnel (ggx_brdf.h:22-24)."""
    w = torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)[..., None]
    return f0 + (1.0 - f0) * w


def roughness_to_alpha(roughness, anisotropy):
    """roughnessToAlpha (ggx_brdf.h:28-37): (..., 2) [alpha_x, alpha_y] with
    alpha = max(1e-3, r^2) * (1 +- a)."""
    alpha = torch.clamp(km.sqr(roughness), min=MIN_ALPHA)
    return torch.stack([alpha * (1.0 + anisotropy), alpha * (1.0 - anisotropy)], -1)


def _lambda(v, alpha):
    """Smith lambda (ggx_brdf.h:41-45)."""
    vz2 = torch.clamp(km.sqr(v[..., 2]), min=1e-9)
    squared = (
        km.sqr(alpha[..., 0]) * km.sqr(v[..., 0])
        + km.sqr(alpha[..., 1]) * km.sqr(v[..., 1])
    ) / vz2
    return (-1.0 + torch.sqrt(1.0 + squared)) * 0.5


def smith_g1(v, h, alpha):
    """G1 (ggx_brdf.h:49-55): zero when v is below the half-vector."""
    g = 1.0 / (1.0 + _lambda(v, alpha))
    return torch.where(km.dot(v, h) <= 0.0, 0.0, g)


def smith_g2(v, l, h, alpha):
    """G2 (ggx_brdf.h:60-67)."""
    g = 1.0 / (1.0 + _lambda(v, alpha) + _lambda(l, alpha))
    return torch.where((km.dot(v, h) <= 0.0) | (km.dot(l, h) < 0.0), 0.0, g)


def ggx_ndf(h, alpha):
    """D (ggx_brdf.h:71-75)."""
    ellipse = (
        km.sqr(h[..., 0]) / km.sqr(alpha[..., 0])
        + km.sqr(h[..., 1]) / km.sqr(alpha[..., 1])
        + km.sqr(h[..., 2])
    )
    return 1.0 / (pymath.pi * alpha[..., 0] * alpha[..., 1] * km.sqr(ellipse))


def vndf(v, h, alpha):
    """Visible-normal distribution Dv (ggx_brdf.h:80-91), also the pdf of
    sample_vndf (ggx_brdf.h:124-127)."""
    vdoth = km.dot(v, h)
    d = ggx_ndf(h, alpha)
    g1 = smith_g1(v, h, alpha)
    vz = torch.where(v[..., 2] == 0.0, 1e-9, v[..., 2])
    val = d * g1 * vdoth / vz
    return torch.where(vdoth <= 0.0, 0.0, val)


def sample_vndf(v, alpha, u2):
    """sampleGGXSmithVNDF (ggx_brdf.h:96-120, Heitz 2018 appendix A)."""
    vh = km.normalize(
        torch.stack([alpha[..., 0] * v[..., 0], alpha[..., 1] * v[..., 1], v[..., 2]], -1)
    )
    lensq = km.sqr(vh[..., 0]) + km.sqr(vh[..., 1])
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-9))
    has_len = (lensq > 0.0)[..., None]
    t1 = torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len, torch.zeros_like(inv_len)], -1)
    with metrics.sync("shade/ggx.py:sample_vndf torch.tensor"):
        x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    t1 = torch.where(has_len, t1, x_axis.expand_as(vh))
    t2 = km.normalize(km.cross(vh, t1))
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * pymath.pi * u2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None] * vh
    )
    return km.normalize(
        torch.stack(
            [
                alpha[..., 0] * nh[..., 0],
                alpha[..., 1] * nh[..., 1],
                torch.clamp(nh[..., 2], min=1e-6),
            ],
            -1,
        )
    )


def eval_ggx_smith_brdf(v, l, f0, roughness, anisotropy):
    """evaluateGGXSmithBRDF (ggx_brdf.h:158-179): returns (brdf, F)."""
    alpha = roughness_to_alpha(roughness, anisotropy)
    h = km.normalize(v + l)
    d = ggx_ndf(h, alpha)
    g = smith_g2(v, l, h, alpha)
    f = schlick_fresnel(f0, km.dot(v, h))
    denom = 4.0 * torch.abs(v[..., 2]) * torch.abs(l[..., 2])
    brdf = (d * g / torch.clamp(denom, min=1e-9))[..., None] * f
    zero = (v[..., 2] * l[..., 2] < 0.0)[..., None]
    return torch.where(zero, 0.0, brdf), f


# ---------------------------------------------------------------------------
# Beckmann microfacet pieces of roughconductor, roughplastic and
# roughdielectric (bsdf.cpp:727-757; each class holds the same copy)
# ---------------------------------------------------------------------------


def beckmann_ndf(m, alpha):
    """evalBeckmann: exp(-tan^2 / a^2) / (pi a^2 cos^4)."""
    ct = m[..., 2]
    ct2 = torch.clamp(km.sqr(ct), min=1e-9)
    tan2 = torch.clamp(1.0 - km.sqr(ct), min=0.0) / ct2
    return torch.exp(-tan2 / km.sqr(alpha)) / (pymath.pi * km.sqr(alpha) * km.sqr(ct2))


def smith_beckmann_g1(v, m, alpha):
    """Rational approximation of Smith-Beckmann G1 (bsdf.cpp:737-757). The
    tangent is clamped to 1e-2 inside the approximation only, where a < 1.6
    selects it, so no taken value changes."""
    ct = v[..., 2]
    tan_theta = torch.abs(
        torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0)) / torch.where(ct == 0.0, 1e-9, ct)
    )
    a = 1.0 / (alpha * torch.clamp(tan_theta, min=1e-2))
    a2 = a * a
    approx = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    g = torch.where((a >= 1.6) | (tan_theta == 0.0), 1.0, approx)
    return torch.where(km.dot(v, m) * ct <= 0.0, 0.0, g)


def fresnel_conductor(cos_theta_i, eta, k):
    """fresnelCond (bsdf.cpp:717-726); eta and k are (..., 3)."""
    ci = cos_theta_i[..., None]
    tmp_f = km.sqr(eta) + km.sqr(k)
    tmp = tmp_f * km.sqr(ci)
    rparl2 = (tmp - 2.0 * eta * ci + 1.0) / (tmp + 2.0 * eta * ci + 1.0)
    rperp2 = (tmp_f - 2.0 * eta * ci + km.sqr(ci)) / (tmp_f + 2.0 * eta * ci + km.sqr(ci))
    return (rparl2 + rperp2) / 2.0
