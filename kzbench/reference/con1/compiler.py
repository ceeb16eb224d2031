"""Scene compiler of configuration 3: ``kz/scene/compiler.py`` with the
normal-map material (its nested material's row first, then a row that names
it and the normal texture) and the thin-lens camera (``camera_kind``,
``aperture_radius``, ``focus_distance``), and the independent sampler.
``_MaterialBuilder.add`` and ``compile_numpy`` are frozen copies of the
port's ``scene/compiler.py`` (cut as ``kz/``'s are); the tables, the texture
packer and ``scene_from_numpy`` are ``kz/``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..kz.core.device import resolve_device
from ..kz.scene import compiler as kz
from ..kz.scene.compiler import (
    BSDF_NORMALMAP,
    SceneArrays,
    SceneStatic,
    _materials_to_numpy,
    _mesh_arrays,
    _sample_to_camera_matrix,
    _TexturePacker,
    scene_from_numpy,
)
from . import description as D
from . import streams


class _MaterialBuilder(kz._MaterialBuilder):
    """``kz/``'s material rows, and a normalmap's: its nested material's row
    first."""

    def add(self, b: Optional[D.BSDF]) -> int:
        if not isinstance(b, D.NormalMap):
            return super().add(b)
        nested_id = self.add(b.nested)
        row = self._blank()
        row["btype"] = BSDF_NORMALMAP
        row["nested"] = nested_id
        _, row["tex_normal"] = self._tex_or_const(b.normals)
        self.rows.append(row)
        return len(self.rows) - 1


def compile_numpy(scene: D.Scene) -> "tuple[dict, dict]":
    """The host half of compile_scene: (arrays, static fields) as numpy
    arrays and Python values, in the layout scene_from_numpy reads."""
    if not isinstance(scene.integrator, D.PathMis):
        raise TypeError("the reference runs the path_mis integrator only")
    if type(scene.camera) not in (D.PerspectiveCamera, D.ThinlensCamera):
        raise TypeError("the reference has the perspective and thin-lens cameras only")
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
    if not mats.rows:
        mats.add(None)
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
    bg_color, bg_tex, bg_intensity = np.zeros(3, np.float32), -1, 1.0
    if bg is not None:
        tex = D.as_texture(bg.texture if bg.texture is not None else (0.0, 0.0, 0.0))
        if isinstance(tex, D.ConstantTexture):
            bg_color = np.asarray(tex.color, np.float32)
        else:
            bg_color = np.ones(3, np.float32)
            bg_tex = packer.add_node(tex)
        bg_intensity = float(bg.intensity)

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
        aperture_radius=np.float32(getattr(cam, "aperture_radius", 0.0)),
        focus_distance=np.float32(getattr(cam, "focus_distance", 0.0)),
        env_row_cdf=env_row_cdf, env_col_cdf=env_col_cdf, env_pdf=env_pdf,
        trace_tables=None,
    )
    static = dict(
        width=cam.width,
        height=cam.height,
        camera_kind="thinlens" if isinstance(cam, D.ThinlensCamera) else "perspective",
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
        env_importance=False,
        env_res=(0, 0),
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
    kind = fields["sampler_kind"]
    if kind not in streams.KINDS:
        raise ValueError(f"unknown sampler kind {kind!r}")
    # kz's scene_from_numpy accepts kz's sampler kinds only, which lack the
    # independent one; the kind moves nothing else it builds
    arrays, static = scene_from_numpy(arrays, dict(fields, sampler_kind="stratified"), device,
                                      megakernel)
    return arrays, dataclasses.replace(static, sampler_kind=kind)
