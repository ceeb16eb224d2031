"""Post-intersection shading preparation (accel.cpp:113-236): Hanika
shadow-terminator-corrected hit point, geometric frame, UV interpolation and
the dpdu/dpdv tangent frame with degenerate-UV and missing-normal fallbacks.

The port of ``kazen_tpu/shade/interaction.py``. ``prepare_from_rows`` reads
the 40-row matrix of ``accel/cluster_trace.py:trace``, which already holds
the winning face's vertices, normals, uvs and metadata (the path_mis
wavefront).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.intersect import Hit, Rays, moller_trumbore
from ..core import math as km
from ..core.math import Frame


class Interaction(NamedTuple):
    p: torch.Tensor  # (N, 3) Hanika-corrected hit point
    t: torch.Tensor  # (N,)
    uv: torch.Tensor  # (N, 2)
    sh_frame: Frame  # shading frame (s, t, n) each (N, 3)
    geo_frame: Frame
    dpdu: torch.Tensor  # (N, 3)
    dpdv: torch.Tensor  # (N, 3)
    material: torch.Tensor  # (N,) int64
    light: torch.Tensor  # (N,) int64, -1 = not emissive
    valid: torch.Tensor  # (N,) bool
    cluster: torch.Tensor  # (N,) int64 cluster id of the hit face (trace row 33)


def prepare_from_rows(rays: Rays, rows: torch.Tensor) -> "tuple[Hit, Interaction]":
    """Shade prep from the trace rows. (t, u, v) are recomputed in closed
    form against the chosen face, as the reference does, so they carry the
    rays' gradient; the fetched geometry rows are constants."""
    rows = rows.detach()
    face_f = rows[3]
    valid = face_f >= 0.0
    face = torch.where(valid, face_f, 0.0).to(torch.int64)
    p0 = rows[4:7].T
    p1 = rows[7:10].T
    p2 = rows[10:13].T
    n0 = rows[13:16].T
    n1 = rows[16:19].T
    n2 = rows[19:22].T
    uv0 = rows[22:24].T
    uv1 = rows[24:26].T
    uv2 = rows[26:28].T
    light = torch.where(valid, rows[28], -1.0).to(torch.int64)
    material = rows[30].to(torch.int64)
    has_n = rows[31] > 0.0
    has_uv = rows[32] > 0.0

    t, u, v, _ = moller_trumbore(rays.o, rays.d, p0, p1, p2)
    t = torch.where(valid, t, rows[0])
    hit = Hit(valid=valid, t=t, face=face, u=u, v=v)
    its = _prepare_core(
        hit, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, material, light, has_n,
        has_uv, rows[33].to(torch.int64),
    )
    return hit, its


def _prepare_core(
    hit, p0, p1, p2, n0, n1, n2, uv0, uv1, uv2, material, light, has_n, has_uv,
    cluster,
) -> Interaction:
    b0 = (1.0 - hit.u - hit.v)[:, None]
    b1 = hit.u[:, None]
    b2 = hit.v[:, None]

    # Hanika 2021 terminator offset (accel.cpp:141-153): project the
    # barycentric point onto each vertex-normal tangent plane and re-average
    orig_p = b0 * p0 + b1 * p1 + b2 * p2
    tmpu = orig_p - p0
    tmpv = orig_p - p1
    tmpw = orig_p - p2
    dotu = torch.clamp(km.dot(tmpu, n0), max=0.0)[:, None]
    dotv = torch.clamp(km.dot(tmpv, n1), max=0.0)[:, None]
    dotw = torch.clamp(km.dot(tmpw, n2), max=0.0)[:, None]
    tmpu = tmpu - dotu * n0
    tmpv = tmpv - dotv * n1
    tmpw = tmpw - dotw * n2
    p_hanika = orig_p + b0 * tmpu + b1 * tmpv + b2 * tmpw
    # without vertex normals the offset is meaningless: the plain point
    p = torch.where(has_n[:, None], p_hanika, orig_p)

    # geometric frame (accel.cpp:156-158)
    dp0 = p1 - p0
    dp1 = p2 - p0
    gn = km.normalize(km.cross(dp0, dp1))
    geo_frame = km.frame_from_normal(gn)

    # UV interpolation (accel.cpp:160-164); prim uv fallback otherwise
    uv_interp = b0 * uv0 + b1 * uv1 + b2 * uv2
    uv = torch.where(has_uv[:, None], uv_interp, torch.stack([hit.u, hit.v], -1))

    # shading frame (accel.cpp:166-235)
    sh_normal = b0 * n0 + b1 * n1 + b2 * n2
    sh_n = km.normalize(sh_normal)

    duv0 = uv1 - uv0
    duv1 = uv2 - uv0
    determinant = duv0[:, 0] * duv1[:, 1] - duv0[:, 1] * duv1[:, 0]
    cross_len = km.norm(km.cross(dp0, dp1))
    uv_ok = has_n & has_uv & (cross_len > 0.0) & (determinant > 0.0)

    inv_det = 1.0 / torch.where(determinant != 0.0, determinant, 1.0)
    dpdu_uv = (duv1[:, 1:2] * dp0 - duv0[:, 1:2] * dp1) * inv_det[:, None]
    dpdv_uv = (-duv1[:, 0:1] * dp0 + duv0[:, 0:1] * dp1) * inv_det[:, None]

    # Gram-Schmidt tangent frame from dpdu (accel.cpp:197-200)
    s_uv = km.normalize(dpdu_uv - sh_normal * km.dot(sh_normal, dpdu_uv, keepdims=True))
    t_uv = km.normalize(km.cross(sh_n, s_uv))

    # fallback: an arbitrary frame around the (shading or geometric) normal
    n_fallback = torch.where(has_n[:, None], sh_n, gn)
    fallback = km.frame_from_normal(n_fallback)

    ok3 = uv_ok[:, None]
    sh_frame = Frame(
        s=torch.where(ok3, s_uv, fallback.s),
        t=torch.where(ok3, t_uv, fallback.t),
        n=torch.where(ok3, sh_n, n_fallback),
    )
    return Interaction(
        p=p,
        t=hit.t,
        uv=uv,
        sh_frame=sh_frame,
        geo_frame=geo_frame,
        dpdu=torch.where(ok3, dpdu_uv, fallback.s),
        dpdv=torch.where(ok3, dpdv_uv, fallback.t),
        material=material,
        light=torch.where(hit.valid, light, -1),
        valid=hit.valid,
        cluster=cluster,
    )
