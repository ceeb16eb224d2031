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


def luminance(c):
    """getLuminance (common.cpp:393-395)."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169
