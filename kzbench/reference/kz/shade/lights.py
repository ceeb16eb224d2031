"""Area lights, uniform light selection and the background (light.cpp,
scene.h:45-57, mesh.cpp:108-133, scene.cpp:54-79).

A frozen copy of the port's lights, without environment sampling. A light
is an emissive mesh: sampling picks a triangle from the per-light area CDF
and warps a uniform pair onto it; pdfs convert the mesh area pdf to solid
angle. The background is a texture looked up by direction (lat-long).

Reference quirk kept: the interpolated light normal is not normalized
(mesh.cpp:126 discards ``n.normalized()``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math as km
from .textures import eval_texture_dir


class LightSample(NamedTuple):
    p: torch.Tensor  # (N, 3) point on the light
    n: torch.Tensor  # (N, 3) light normal (unnormalized interpolation)
    wi: torch.Tensor  # (N, 3) reference point -> light, unit
    dist: torch.Tensor  # (N,)
    pdf: torch.Tensor  # (N,) solid-angle pdf
    ls: torch.Tensor  # (N, 3) Le / pdf (light.cpp:30-33), 0 when invalid


def select_uniform(num_lights: int, u: torch.Tensor) -> torch.Tensor:
    """Scene::getRandomLight (scene.h:45-53): min(floor(n*u), n-1)."""
    idx = torch.floor(num_lights * u).to(torch.int64)
    return torch.clamp(idx, 0, num_lights - 1)


def sample_area_light(scene, light_idx, ref_p, u_tri, u1, u2) -> LightSample:
    """AreaLight::sample via Mesh::sample (light.cpp:21-34, mesh.cpp:108-133):
    u_tri picks the triangle from the CDF, (u1, u2) warp onto it."""
    max_lf = scene.light_faces.shape[1]
    cdf_rows = scene.light_cdf[light_idx]  # (N, max_lf + 1)
    tri = (u_tri[:, None] >= cdf_rows[:, 1:max_lf]).sum(dim=1)
    tri = torch.clamp(tri, 0, max_lf - 1)

    su0 = torch.sqrt(u1)
    u = 1.0 - su0
    v = u2 * su0

    row = scene.face_shade[scene.light_faces[light_idx, tri]]
    p0 = row[:, 0:3]
    p1 = row[:, 3:6]
    p2 = row[:, 6:9]
    p = p0 + u[:, None] * (p1 - p0) + v[:, None] * (p2 - p0)

    has_n = scene.mesh_has_normals[scene.light_mesh][light_idx]
    n0 = row[:, 9:12]
    n1 = row[:, 12:15]
    n2 = row[:, 15:18]
    n_interp = n0 + u[:, None] * (n1 - n0) + v[:, None] * (n2 - n0)
    n_geo = km.normalize(km.cross(p1 - p0, p2 - p0))
    n = torch.where(has_n[:, None], n_interp, n_geo)

    to_light = p - ref_p
    dist = km.norm(to_light)
    wi = to_light / torch.clamp(dist, min=1e-9)[:, None]

    pdf = pdf_area_light(scene, light_idx, n, wi, dist)
    radiance = eval_area_light(scene, light_idx, n, wi)
    valid = (pdf > 0.0) & torch.isfinite(pdf)
    ls = torch.where(
        valid[:, None], radiance / torch.clamp(pdf, min=1e-9)[:, None], 0.0
    )
    return LightSample(p=p, n=n, wi=wi, dist=dist, pdf=pdf, ls=ls)


def eval_area_light(scene, light_idx, n, wi):
    """AreaLight::eval (light.cpp:16-19): one-sided radiance."""
    cos_theta = km.dot(n, -wi)
    rad = torch.index_select(scene.light_radiance, 0, light_idx)  # see MaterialTable.rows
    return torch.where((cos_theta > 0.0)[:, None], rad, 0.0)


def pdf_area_light(scene, light_idx, n, wi, dist):
    """AreaLight::pdf (light.cpp:36-51): area -> solid-angle conversion."""
    cos_theta = km.dot(n, -wi)
    inv_area = scene.light_inv_area[light_idx]
    pdf = inv_area * km.sqr(dist) / torch.clamp(cos_theta, min=1e-9)
    return torch.where(cos_theta > 0.0, pdf, 0.0)


def background_radiance(scene, static, d):
    """Scene::getBackgroundColor (scene.cpp:54-79): the environment texture
    by direction, intensity-scaled (texture.cpp:104-145), zero along
    non-finite directions. With mip filtering, the lookup takes one pixel's
    cone mapped through the lat-long v axis (dv/dlat = 1/pi) as its
    footprint; each texture adds its own resolution."""
    if not static.has_background:
        return torch.zeros_like(d)
    if not (static.has_image_textures or static.has_composite_textures):
        # every node is a constant, so the background is bg_color (a
        # constant background texture compiles to bg_tex = -1)
        col = (scene.bg_intensity * scene.bg_color).expand_as(d)
        return torch.where(torch.isfinite(d).all(dim=-1)[..., None], col, 0.0)
    lod = None
    if getattr(static, "mip_textures", False) and static.pixel_cone > 0.0:
        lod = torch.full(
            d.shape[:-1],
            float(np.float32(np.log2(max(static.pixel_cone / np.pi, 1e-9)))),
            device=d.device,
        )
    col = eval_texture_dir(
        static, scene.textures, scene.bg_tex.expand(d.shape[:-1]), d,
        scene.bg_color.expand_as(d), lod=lod,
    )
    col = scene.bg_intensity * col
    finite = torch.isfinite(d).all(dim=-1)
    return torch.where(finite[..., None], col, 0.0)
