"""Scene compiler of the Textured configuration: ``con1/compiler.py``'s
(the normal map) with the rough* materials and the importance-sampled
background. ``_MaterialBuilder.add``'s rough* rows, ``CONDUCTORS``,
``_build_env_tables`` and ``compile_numpy`` are frozen copies of the port's
``scene/compiler.py`` (cut as ``kz/``'s are); the tables, the texture
packer and ``scene_from_numpy`` are ``kz/``'s.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..con1 import compiler as con1
from ..kz.core.device import resolve_device
from ..kz.scene.compiler import (
    BSDF_ROUGHCONDUCTOR,
    BSDF_ROUGHDIELECTRIC,
    BSDF_ROUGHPLASTIC,
    SceneArrays,
    SceneStatic,
    _materials_to_numpy,
    _mesh_arrays,
    _pool_to_device,
    _sample_to_camera_matrix,
    _TexturePacker,
    scene_from_numpy,
)
from ..kz.shade.textures import eval_texture_dir
from . import description as D

# Conductor Fresnel presets (eta, k) per channel (bsdf.cpp:703-713)
CONDUCTORS = {
    "Au": ((0.1431889, 0.3749570, 1.4424879), (3.9831604, 2.3857207, 1.6032152)),
    "Cu": ((0.2004376, 0.9240334, 1.1022119), (3.9129485, 2.4528477, 2.1421879)),
    "Cr": ((4.3696842, 2.9167024, 1.6547005), (5.2064351, 4.2313262, 3.7549467)),
}
ENV_TABLE_RES = (256, 512)  # (Eh, Ew) of the lat-long importance tables


class _MaterialBuilder(con1._MaterialBuilder):
    """``con1/``'s material rows, and the rough* ones."""

    def add(self, b: Optional[D.BSDF]) -> int:
        if not isinstance(b, (D.RoughConductor, D.RoughPlastic, D.RoughDielectric)):
            return super().add(b)
        row = self._blank()
        if isinstance(b, D.RoughConductor):
            row["btype"] = BSDF_ROUGHCONDUCTOR
            eta, k = CONDUCTORS[b.material]
            row["eta_c"] = np.asarray(eta, np.float32)
            row["k_c"] = np.asarray(k, np.float32)
            row["alpha"] = max(1e-3, b.alpha**2)  # bsdf.cpp:695-700
        elif isinstance(b, D.RoughPlastic):
            row["btype"] = BSDF_ROUGHPLASTIC
            row["alpha"] = max(1e-3, b.alpha**2)
            row["int_ior"] = b.int_ior
            row["ext_ior"] = b.ext_ior
            row["base_color"] = np.asarray(b.kd, np.float32)
        else:
            row["btype"] = BSDF_ROUGHDIELECTRIC
            row["alpha"] = max(1e-3, b.roughness**2)
            row["int_ior"] = b.int_ior
            row["ext_ior"] = b.ext_ior
        self.rows.append(row)
        return len(self.rows) - 1


def _build_env_tables(pool: dict, bg_tex, bg_color, bg_intensity, has_comp, has_img):
    """Rasterize the background onto a lat-long luminance grid and build the
    row marginal and per-row conditional CDFs and the solid-angle pdf of
    each texel, with a 1% floor of the mean luminance."""
    eh, ew = ENV_TABLE_RES
    v = (np.arange(eh) + 0.5) / eh
    u = (np.arange(ew) + 0.5) / ew
    lat = ((v - 0.5) * np.pi).astype(np.float32)  # [-pi/2, pi/2]
    phi = (u * 2.0 * np.pi - np.pi).astype(np.float32)
    cos_lat = np.cos(lat)
    y = np.broadcast_to(np.sin(lat)[:, None], (eh, ew))
    x = cos_lat[:, None] * np.sin(phi)[None, :]
    z = cos_lat[:, None] * np.cos(phi)[None, :]
    dirs = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    # the lookup reads only these two statics (no mip level)
    flags = SimpleNamespace(has_composite_textures=has_comp, has_image_textures=has_img)
    n = dirs.shape[0]
    rad = eval_texture_dir(
        flags, _pool_to_device(pool, "cpu"), torch.full((n,), int(bg_tex)),
        torch.from_numpy(dirs), torch.from_numpy(np.asarray(bg_color, np.float32)).expand(n, 3),
    ).numpy() * float(bg_intensity)
    lum = (0.212671 * rad[:, 0] + 0.715160 * rad[:, 1] + 0.072169 * rad[:, 2]).reshape(eh, ew)
    lum = np.maximum(lum, 0.0)
    mean_lum = float(lum.mean())
    if mean_lum <= 0.0:
        lum = np.ones_like(lum)
        mean_lum = 1.0
    w = (lum + 0.01 * mean_lum) * cos_lat[:, None]  # dOmega ~ cos(lat) du dv
    total = float(w.sum())
    row_w = w.sum(axis=1)
    row_cdf = np.zeros(eh + 1, np.float64)
    row_cdf[1:] = np.cumsum(row_w) / total
    row_cdf[-1] = 1.0
    col_cdf = np.zeros((eh, ew + 1), np.float64)
    safe_row = np.where(row_w > 0.0, row_w, 1.0)
    col_cdf[:, 1:] = np.cumsum(w, axis=1) / safe_row[:, None]
    col_cdf[:, -1] = 1.0
    # p(u, v) = w / total * Eh * Ew; dOmega = 2 pi^2 cos(lat) du dv
    pdf = (w / total * (eh * ew)) / (2.0 * np.pi * np.pi * np.maximum(cos_lat[:, None], 1e-6))
    return row_cdf.astype(np.float32), col_cdf.astype(np.float32), pdf.astype(np.float32)


def compile_numpy(scene: D.Scene) -> "tuple[dict, dict]":
    """The host half of compile_scene: (arrays, static fields) as numpy
    arrays and Python values, in the layout scene_from_numpy reads."""
    if not isinstance(scene.integrator, D.PathMis):
        raise TypeError("the reference runs the path_mis integrator only")
    if type(scene.camera) is not D.PerspectiveCamera:
        raise TypeError("the reference has the perspective camera only")
    packer = _TexturePacker(build_mips=bool(scene.mip_textures))
    mats = _MaterialBuilder(packer)
    Vs, Fs, Ns, UVs, face_mesh = [], [], [], [], []
    mesh_material, mesh_light, has_n, has_uv, lights = [], [], [], [], []
    vert_off = face_off = 0
    for mi, mesh in enumerate(scene.meshes):
        V, F, N, UV = _mesh_arrays(mesh)
        nv, nf = len(V), len(F)
        Vs.append(V)
        Fs.append(F + vert_off)
        Ns.append(N if N is not None else np.zeros((nv, 3), np.float32))
        UVs.append(UV if UV is not None else np.zeros((nv, 2), np.float32))
        face_mesh.append(np.full(nf, mi, np.int32))
        mesh_material.append(mats.add(mesh.bsdf))
        has_n.append(N is not None)
        has_uv.append(UV is not None)
        if mesh.light is not None:
            p0 = V[F[:, 0]]
            areas = 0.5 * np.linalg.norm(
                np.cross(V[F[:, 1]] - p0, V[F[:, 2]] - p0), axis=-1
            )
            mesh_light.append(len(lights))
            lights.append((mi, mesh.light, face_off, nf, areas))
        else:
            mesh_light.append(-1)
        vert_off += nv
        face_off += nf
    if not Fs:
        raise ValueError("empty scene")
    V = np.concatenate(Vs)
    F = np.concatenate(Fs)
    N = np.concatenate(Ns)
    UV = np.concatenate(UVs)
    face_mesh = np.concatenate(face_mesh)

    # lights: per-light triangle CDF over global face ids (mesh.cpp:31-44)
    L = len(lights)
    max_lf = max((lf for (_, _, _, lf, _) in lights), default=1)
    light_mesh = np.zeros((max(L, 1),), np.int32)
    light_radiance = np.zeros((max(L, 1), 3), np.float32)
    light_primary = np.zeros((max(L, 1),), bool)
    light_cdf = np.zeros((max(L, 1), max_lf + 1), np.float32)
    light_faces = np.zeros((max(L, 1), max_lf), np.int32)
    light_inv_area = np.ones((max(L, 1),), np.float32)
    for li, (mi, al, fstart, fcount, areas) in enumerate(lights):
        light_mesh[li] = mi
        light_radiance[li] = np.asarray(al.color, np.float32) * al.intensity
        light_primary[li] = al.primary_visibility
        total = float(areas.sum())
        cdf = np.concatenate([[0.0], np.cumsum(areas / total, dtype=np.float64)])
        cdf[-1] = 1.0
        light_cdf[li, : fcount + 1] = cdf.astype(np.float32)
        light_cdf[li, fcount + 1:] = 1.0
        light_faces[li, :fcount] = np.arange(fstart, fstart + fcount, dtype=np.int32)
        light_faces[li, fcount:] = fstart + fcount - 1
        light_inv_area[li] = 1.0 / total

    bg = scene.background
    bg_color, bg_tex, bg_intensity, env_importance = np.zeros(3, np.float32), -1, 1.0, False
    if bg is not None:
        tex = D.as_texture(bg.texture if bg.texture is not None else (0.0, 0.0, 0.0))
        if isinstance(tex, D.ConstantTexture):
            bg_color = np.asarray(tex.color, np.float32)
        else:
            bg_color = np.ones(3, np.float32)
            bg_tex = packer.add_node(tex)
        bg_intensity = float(bg.intensity)
        env_importance = bool(getattr(bg, "importance", False))

    cam = scene.camera
    integ = scene.integrator
    integrator = dict(
        integrator_kind="path_mis", max_depth=min(512, integ.max_depth),
        trace_bias=integ.trace_bias, regularization=integ.regularization,
        accumulated_roughness=integ.accumulated_roughness,
    )
    face_shade = np.concatenate(
        [
            V[F[:, 0]], V[F[:, 1]], V[F[:, 2]],
            N[F[:, 0]], N[F[:, 1]], N[F[:, 2]],
            UV[F[:, 0]], UV[F[:, 1]], UV[F[:, 2]],
        ],
        axis=1,
    ).astype(np.float32)
    pool = packer.finish()
    has_comp, has_img = packer.flags()
    if env_importance:
        env_row_cdf, env_col_cdf, env_pdf = _build_env_tables(
            pool, bg_tex, bg_color, bg_intensity, has_comp, has_img
        )
    else:
        env_row_cdf = np.zeros(2, np.float32)
        env_col_cdf = np.zeros((1, 2), np.float32)
        env_pdf = np.zeros((1, 1), np.float32)
    arrays = dict(
        V=V, F=F, N=N, UV=UV, face_shade=face_shade, face_mesh=face_mesh,
        mesh_material=np.asarray(mesh_material, np.int32),
        mesh_light=np.asarray(mesh_light, np.int32),
        mesh_has_normals=np.asarray(has_n, bool),
        mesh_has_uvs=np.asarray(has_uv, bool),
        materials=_materials_to_numpy(mats.rows),
        textures=pool,
        light_mesh=light_mesh, light_radiance=light_radiance,
        light_primary_vis=light_primary, light_cdf=light_cdf,
        light_faces=light_faces, light_inv_area=light_inv_area,
        bg_color=bg_color, bg_tex=np.int32(bg_tex), bg_intensity=np.float32(bg_intensity),
        cam_to_world=(
            np.asarray(cam.to_world, np.float32)
            if cam.to_world is not None else np.eye(4, dtype=np.float32)
        ),
        sample_to_camera=_sample_to_camera_matrix(cam),
        cam_near=np.float32(cam.near_clip),
        cam_far=np.float32(cam.far_clip),
        aperture_radius=np.float32(0.0),
        focus_distance=np.float32(0.0),
        env_row_cdf=env_row_cdf, env_col_cdf=env_col_cdf, env_pdf=env_pdf,
        trace_tables=None,
    )
    static = dict(
        width=cam.width,
        height=cam.height,
        camera_kind="perspective",
        num_meshes=len(scene.meshes),
        num_materials=len(mats.rows),
        num_lights=L,
        btypes_present=tuple(sorted({int(r["btype"]) for r in mats.rows})),
        has_composite_textures=has_comp,
        has_image_textures=has_img,
        has_background=bg is not None,
        sampler_kind=scene.sampler.kind,
        sample_count=scene.sampler.sample_count,
        seed=scene.sampler.seed,
        **integrator,
        rfilter_kind=scene.rfilter.kind,
        rfilter_radius=scene.rfilter.radius,
        rfilter_stddev=scene.rfilter.stddev,
        rfilter_b=scene.rfilter.b,
        rfilter_c=scene.rfilter.c,
        env_importance=env_importance,
        env_res=ENV_TABLE_RES if env_importance else (0, 0),
        mip_textures=bool(scene.mip_textures),
        aniso_textures=bool(getattr(scene, "aniso_textures", True)),
        pixel_cone=float(2.0 * np.tan(np.deg2rad(cam.fov) / 2.0) / cam.height),
    )
    return arrays, static


def compile_scene(
    scene: D.Scene, device="cuda", megakernel: Optional[bool] = None,
) -> "tuple[SceneArrays, SceneStatic]":
    """Compile a scene description onto ``device`` (CUDA unless the caller
    asks for the CPU); ``megakernel`` is accepted and ignored."""
    device = resolve_device(device)
    arrays, fields = compile_numpy(scene)
    return scene_from_numpy(arrays, fields, device, megakernel)
