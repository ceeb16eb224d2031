"""Batched vector math: frames, optics, color transforms (vector.h, frame.h,
common.cpp:396-538). Functions work on tensors whose last axis is the vector
axis, like ``kazen_tpu/core/math.py``. Small-table row fetches are plain
indexing here (the TPU's where-chain ``select_rows`` has no use on a GPU)."""
from __future__ import annotations

import math as pymath
from typing import NamedTuple

import torch

EPSILON = 1e-4
INV_PI = 1.0 / pymath.pi
INV_TWOPI = 0.5 / pymath.pi
INV_FOURPI = 0.25 / pymath.pi


def dot(a, b, keepdims: bool = False):
    return (a * b).sum(dim=-1, keepdim=keepdims)


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def norm(v, keepdims: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims=keepdims), min=1e-18))


def normalize(v):
    return v / torch.clamp(norm(v, keepdims=True), min=1e-9)


def sqr(x):
    return x * x


def vec3(x, y, z):
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


class Frame(NamedTuple):
    """Shading/geometric frame: rows s, t, n each (..., 3)."""

    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor

    def to_local(self, v):
        return vec3(dot(v, self.s), dot(v, self.t), dot(v, self.n))

    def to_world(self, v):
        return (
            self.s * v[..., 0:1] + self.t * v[..., 1:2] + self.n * v[..., 2:3]
        )


def coordinate_system(a):
    """coordinateSystem (common.cpp:434-445): (b, c) with c chosen by the
    |a.x| > |a.y| rule and b = c x a."""
    ax, ay, az = a.unbind(-1)
    use_x = torch.abs(ax) > torch.abs(ay)
    inv_len_x = 1.0 / torch.sqrt(ax * ax + az * az + 1e-30)
    inv_len_y = 1.0 / torch.sqrt(ay * ay + az * az + 1e-30)
    zero = torch.zeros_like(ax)
    c_x = vec3(az * inv_len_x, zero, -ax * inv_len_x)
    c_y = vec3(zero, az * inv_len_y, -ay * inv_len_y)
    c = torch.where(use_x[..., None], c_x, c_y)
    return cross(c, a), c


def frame_from_normal(n) -> Frame:
    s, t = coordinate_system(n)
    return Frame(s=s, t=t, n=n)


def reflect(wi, n):
    """2(n.wi)n - wi (common.cpp:535-537)."""
    return 2.0 * dot(wi, n, keepdims=True) * n - wi


def refract(wi, n, eta):
    """Snell refraction (common.cpp:522-532); 0 on total internal reflection.
    The sqrt argument is substituted on TIR lanes before the sqrt, so the
    backward pass stays finite there."""
    cos_i = dot(wi, n)
    eta_eff = torch.where(cos_i < 0.0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) * (eta_eff * eta_eff)
    sign = torch.where(cos_i >= 0.0, 1.0, -1.0)
    ok = cos_t2 > 0.0
    ct = torch.sqrt(torch.where(ok, cos_t2, 1.0))
    wt = n * (-cos_i * eta_eff + sign * ct)[..., None] + wi * eta_eff[..., None]
    return torch.where(ok[..., None], wt, 0.0)


def fresnel(cos_theta_i, ext_ior, int_ior):
    """Unpolarized dielectric Fresnel reflectance (common.cpp:447-476)."""
    enter = cos_theta_i >= 0.0
    eta_i = torch.where(enter, ext_ior, int_ior)
    eta_t = torch.where(enter, int_ior, ext_ior)
    ci = torch.abs(cos_theta_i)
    eta = eta_i / eta_t
    sin_t2 = eta * eta * (1.0 - ci * ci)
    ok = sin_t2 < 1.0
    ct = torch.sqrt(torch.where(ok, 1.0 - sin_t2, 1.0))  # TIR: see refract
    rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct)
    rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct)
    f = torch.where(ok, 0.5 * (rs * rs + rp * rp), 1.0)
    return torch.where(ext_ior == int_ior, 0.0, f)


def fresnel_dielectric(cos_theta_i, eta):
    """fresnelDielectric with cosThetaT out (common.cpp:491-517); eta =
    int_ior / ext_ior. Returns (F, cos_theta_t)."""
    scale = torch.where(cos_theta_i > 0.0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * (scale * scale)
    ci = torch.abs(cos_theta_i)
    ok = cos_t2 > 0.0
    ct = torch.sqrt(torch.where(ok, cos_t2, 1.0))  # TIR: see refract
    rs = (ci - eta * ct) / (ci + eta * ct)
    rp = (eta * ci - ct) / (eta * ci + ct)
    f = torch.where(ok, 0.5 * (rs * rs + rp * rp), 1.0)
    cos_theta_t = torch.where(ok, torch.where(cos_theta_i > 0.0, -ct, ct), 0.0)
    return f, cos_theta_t


def to_srgb(c):
    return torch.where(
        c <= 0.0031308,
        12.92 * c,
        1.055 * torch.pow(torch.clamp(c, min=1e-12), 1.0 / 2.4) - 0.055,
    )


def luminance(c):
    """getLuminance (common.cpp:393-395)."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169
