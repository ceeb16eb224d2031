"""Scene compiler: lowers the scene description to flat tensors.

The port of ``kazen_tpu/scene/compiler.py`` for the features ported so far:
inline meshes; diffuse, lambertian, mirror, dielectric, GGX and kiss
materials with constant textures; area lights, a constant background,
perspective and thinlens cameras, the path_mis integrator and the
independent/stratified/correlated samplers. Anything else raises
NotImplementedError naming the feature.

The result is ``(SceneArrays, SceneStatic)``: a dataclass of tensors on one
device and a frozen dataclass of Python values. Cluster trace tables are
always packed, whatever the scene's size. A scene in the megakernel's class
(integrate/megakernel.py:supported_reason: at most 128 faces, 16 materials
and 64 light triangles, constant textures) also gets the megakernel's
tables, and on CUDA ``use_megakernel``: render() then runs the whole path
of a lane in one kernel, as the reference does on its accelerator.
``scene_from_numpy`` builds the same pair from kazen_tpu's compiled scene
converted to numpy.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..accel import cluster_trace as ct
from ..core.device import resolve_device
from ..samplers.streams import KINDS as SAMPLER_KINDS
from . import description as D

# Material type ids (shade/bsdf.py dispatches on these); the numbering is
# kazen_tpu's, so compiled tables compare one to one
BSDF_DIFFUSE = 0
BSDF_DIELECTRIC = 1
BSDF_MIRROR = 2
BSDF_LAMBERTIAN = 3
BSDF_GGX = 4
BSDF_ROUGHCONDUCTOR = 5
BSDF_ROUGHPLASTIC = 6
BSDF_ROUGHDIELECTRIC = 7
BSDF_KISS = 8
BSDF_NORMALMAP = 9


@dataclass
class MaterialTable:
    btype: torch.Tensor  # (M,) int64
    base_color: torch.Tensor  # (M, 3)
    tex_base: torch.Tensor  # (M,) int64, -1 = constant
    metallic: torch.Tensor
    tex_metallic: torch.Tensor
    roughness: torch.Tensor
    tex_roughness: torch.Tensor
    anisotropy: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_roughness: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    int_ior: torch.Tensor
    ext_ior: torch.Tensor
    alpha: torch.Tensor
    eta_c: torch.Tensor  # (M, 3)
    k_c: torch.Tensor  # (M, 3)
    nested: torch.Tensor
    tex_normal: torch.Tensor

    def rows(self, idx) -> "MaterialTable":
        """Per-lane material rows for material ids ``idx``."""
        return MaterialTable(
            **{f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(self)}
        )


_MATERIAL_INT = {"btype", "tex_base", "tex_metallic", "tex_roughness", "nested", "tex_normal"}


@dataclass
class SceneArrays:
    V: torch.Tensor  # (Nv, 3)
    F: torch.Tensor  # (Nf, 3) int64
    N: torch.Tensor  # (Nv, 3), zeros where absent
    UV: torch.Tensor  # (Nv, 2)
    face_shade: torch.Tensor  # (Nf, 24) [p0 p1 p2 n0 n1 n2 uv0 uv1 uv2]
    face_mesh: torch.Tensor  # (Nf,) int64
    mesh_material: torch.Tensor  # (Nm,) int64
    mesh_light: torch.Tensor  # (Nm,) int64, -1 = not a light
    mesh_has_normals: torch.Tensor  # (Nm,) bool
    mesh_has_uvs: torch.Tensor  # (Nm,) bool
    materials: MaterialTable
    light_mesh: torch.Tensor  # (L,) int64
    light_radiance: torch.Tensor  # (L, 3)
    light_primary_vis: torch.Tensor  # (L,) bool
    light_cdf: torch.Tensor  # (L, maxLF + 1) normalized area CDF
    light_faces: torch.Tensor  # (L, maxLF) int64 global face ids
    light_inv_area: torch.Tensor  # (L,)
    bg_color: torch.Tensor  # (3,)
    bg_intensity: torch.Tensor  # ()
    cam_to_world: torch.Tensor  # (4, 4)
    sample_to_camera: torch.Tensor  # (4, 4)
    cam_near: torch.Tensor  # ()
    cam_far: torch.Tensor  # ()
    aperture_radius: torch.Tensor  # ()
    focus_distance: torch.Tensor  # ()
    trace_tables: ct.ClusterTables
    mega: Optional[object] = None  # integrate/megakernel.py:MegaTables

    @property
    def device(self) -> torch.device:
        return self.V.device


@dataclass(frozen=True)
class SceneStatic:
    width: int
    height: int
    camera_kind: str  # "perspective" | "thinlens"
    num_meshes: int
    num_materials: int
    num_lights: int
    btypes_present: Tuple[int, ...]
    has_background: bool
    sampler_kind: str
    sample_count: int
    seed: int
    integrator_kind: str
    max_depth: int
    trace_bias: float
    regularization: bool
    accumulated_roughness: float
    rfilter_kind: str
    rfilter_radius: float
    rfilter_stddev: float
    rfilter_b: float
    rfilter_c: float
    pixel_cone: float = 0.0
    use_megakernel: bool = False  # render() takes integrate/megakernel.py
    mega_cfg: Optional[Tuple] = None  # the megakernel's static config


PORTED_BTYPES = (
    BSDF_DIFFUSE, BSDF_DIELECTRIC, BSDF_MIRROR, BSDF_LAMBERTIAN, BSDF_GGX, BSDF_KISS,
)


def _constant(tex, what: str) -> np.ndarray:
    tex = D.as_texture(tex)
    if not isinstance(tex, D.ConstantTexture):
        raise NotImplementedError(
            f"{type(tex).__name__} for {what} is not ported to kazen_tpu_torch "
            "yet (constant textures only)"
        )
    return np.asarray(tex.color, np.float32)


def _material_row(b: Optional[D.BSDF]) -> dict:
    """One material-table row with kazen_tpu's defaults."""
    row = dict(
        btype=BSDF_DIFFUSE,
        base_color=np.asarray([0.5, 0.5, 0.5], np.float32),
        tex_base=-1, metallic=0.0, tex_metallic=-1, roughness=0.5,
        tex_roughness=-1, anisotropy=0.0, specular=0.5, specular_tint=0.5,
        clearcoat=0.0, clearcoat_roughness=0.5, sheen=0.0, sheen_tint=0.5,
        int_ior=1.5046, ext_ior=1.000277, alpha=0.1,
        eta_c=np.zeros(3, np.float32), k_c=np.zeros(3, np.float32),
        nested=-1, tex_normal=-1,
    )
    if b is None:
        b = D.Diffuse()  # default material (mesh.cpp:25-28)
    if isinstance(b, D.Diffuse):
        row["base_color"] = np.asarray(b.albedo, np.float32)
    elif isinstance(b, D.Dielectric):
        row["btype"] = BSDF_DIELECTRIC
        row["int_ior"] = b.int_ior
        row["ext_ior"] = b.ext_ior
    elif isinstance(b, D.Mirror):
        row["btype"] = BSDF_MIRROR
    elif isinstance(b, D.Lambertian):
        row["btype"] = BSDF_LAMBERTIAN
        row["base_color"] = _constant(b.albedo, "lambertian albedo")
    elif isinstance(b, D.GGX):
        row["btype"] = BSDF_GGX
        row["base_color"] = _constant(b.albedo, "ggx albedo")
        row["roughness"] = b.roughness
        row["anisotropy"] = b.anisotropy
    elif isinstance(b, D.KazenStandard):
        row["btype"] = BSDF_KISS
        row["base_color"] = _constant(b.base_color, "kiss baseColor")
        row["metallic"] = float(_constant(b.metallic, "kiss metallic")[0])
        row["roughness"] = float(_constant(b.roughness, "kiss roughness")[0])
        for k in ("anisotropy", "specular", "specular_tint", "clearcoat",
                  "clearcoat_roughness", "sheen", "sheen_tint"):
            row[k] = getattr(b, k)
    else:
        raise NotImplementedError(
            f"BSDF {type(b).__name__} is not ported to kazen_tpu_torch yet "
            "(diffuse, lambertian, mirror, dielectric, ggx and kiss only)"
        )
    return row


def _materials_to_numpy(rows) -> dict:
    out = {}
    for name in rows[0]:
        vals = [r[name] for r in rows]
        if name in ("base_color", "eta_c", "k_c"):
            out[name] = np.stack(vals).astype(np.float32)
        elif name in _MATERIAL_INT:
            out[name] = np.asarray(vals, np.int32)
        else:
            out[name] = np.asarray(vals, np.float32)
    return out


def _sample_to_camera_matrix(cam: D.PerspectiveCamera) -> np.ndarray:
    """Perspective projection + screen mapping inverse (camera.cpp:35-63)."""
    aspect = cam.width / cam.height
    recip = 1.0 / (cam.far_clip - cam.near_clip)
    cot = 1.0 / np.tan(np.deg2rad(cam.fov / 2.0))
    perspective = np.array(
        [
            [cot, 0, 0, 0],
            [0, cot, 0, 0],
            [0, 0, cam.far_clip * recip, -cam.near_clip * cam.far_clip * recip],
            [0, 0, 1, 0],
        ],
        np.float64,
    )
    scale = np.diag([-0.5, -0.5 * aspect, 1.0, 1.0])
    translate = np.eye(4)
    translate[:3, 3] = [-1.0, -1.0 / aspect, 0.0]
    return np.linalg.inv(scale @ translate @ perspective).astype(np.float32)


def _mesh_arrays(m: D.Mesh):
    if m.filename is not None:
        raise NotImplementedError(
            "OBJ mesh loading is not ported to kazen_tpu_torch yet (inline "
            "vertices/faces only)"
        )
    V = np.asarray(m.vertices, np.float32)
    F = np.asarray(m.faces, np.int32)
    N = None if m.normals is None else np.asarray(m.normals, np.float32)
    UV = None if m.uvs is None else np.asarray(m.uvs, np.float32)
    if m.to_world is not None:
        t = np.asarray(m.to_world, np.float32)
        V = V @ t[:3, :3].T + t[:3, 3]
        if N is not None:
            nmat = np.linalg.inv(t[:3, :3]).T
            N = N @ nmat.T
            N /= np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-9)
    return V, F, N, UV


def compile_numpy(scene: D.Scene) -> "tuple[dict, dict]":
    """The host half of compile_scene: (arrays, static fields) as numpy
    arrays and Python values, in the layout scene_from_numpy reads."""
    Vs, Fs, Ns, UVs, face_mesh = [], [], [], [], []
    mat_rows, mesh_light, has_n, has_uv, lights = [], [], [], [], []
    vert_off = face_off = 0
    for mi, mesh in enumerate(scene.meshes):
        V, F, N, UV = _mesh_arrays(mesh)
        nv, nf = len(V), len(F)
        Vs.append(V)
        Fs.append(F + vert_off)
        Ns.append(N if N is not None else np.zeros((nv, 3), np.float32))
        UVs.append(UV if UV is not None else np.zeros((nv, 2), np.float32))
        face_mesh.append(np.full(nf, mi, np.int32))
        mat_rows.append(_material_row(mesh.bsdf))
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
    if not mat_rows:
        mat_rows.append(_material_row(None))
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
    if bg is not None:
        if getattr(bg, "importance", False):
            raise NotImplementedError(
                "environment importance sampling is not ported to "
                "kazen_tpu_torch yet"
            )
        bg_color = _constant(
            bg.texture if bg.texture is not None else (0.0, 0.0, 0.0), "background"
        )
        bg_intensity = float(bg.intensity)
    else:
        bg_color = np.zeros(3, np.float32)
        bg_intensity = 1.0

    cam = scene.camera
    integ = scene.integrator
    if not isinstance(integ, D.PathMis):
        raise NotImplementedError(
            f"integrator {getattr(integ, 'kind', type(integ).__name__)!r} is "
            "not ported to kazen_tpu_torch yet (path_mis only)"
        )
    face_shade = np.concatenate(
        [
            V[F[:, 0]], V[F[:, 1]], V[F[:, 2]],
            N[F[:, 0]], N[F[:, 1]], N[F[:, 2]],
            UV[F[:, 0]], UV[F[:, 1]], UV[F[:, 2]],
        ],
        axis=1,
    ).astype(np.float32)
    materials = _materials_to_numpy(mat_rows)
    arrays = dict(
        V=V, F=F, N=N, UV=UV, face_shade=face_shade, face_mesh=face_mesh,
        mesh_material=np.arange(len(mat_rows), dtype=np.int32),
        mesh_light=np.asarray(mesh_light, np.int32),
        mesh_has_normals=np.asarray(has_n, bool),
        mesh_has_uvs=np.asarray(has_uv, bool),
        materials=materials,
        light_mesh=light_mesh, light_radiance=light_radiance,
        light_primary_vis=light_primary, light_cdf=light_cdf,
        light_faces=light_faces, light_inv_area=light_inv_area,
        bg_color=bg_color, bg_intensity=np.float32(bg_intensity),
        cam_to_world=(
            np.asarray(cam.to_world, np.float32)
            if cam.to_world is not None else np.eye(4, dtype=np.float32)
        ),
        sample_to_camera=_sample_to_camera_matrix(cam),
        cam_near=np.float32(cam.near_clip),
        cam_far=np.float32(cam.far_clip),
        aperture_radius=np.float32(getattr(cam, "aperture_radius", 0.0)),
        focus_distance=np.float32(getattr(cam, "focus_distance", 0.0)),
        trace_tables=None,
    )
    static = dict(
        width=cam.width,
        height=cam.height,
        camera_kind="thinlens" if isinstance(cam, D.ThinlensCamera) else "perspective",
        num_meshes=len(scene.meshes),
        num_materials=len(mat_rows),
        num_lights=L,
        btypes_present=tuple(sorted({int(r["btype"]) for r in mat_rows})),
        has_composite_textures=False,
        has_image_textures=False,
        has_background=bg is not None,
        sampler_kind=scene.sampler.kind,
        sample_count=scene.sampler.sample_count,
        seed=scene.sampler.seed,
        integrator_kind="path_mis",
        max_depth=min(512, integ.max_depth),
        trace_bias=integ.trace_bias,
        regularization=integ.regularization,
        accumulated_roughness=integ.accumulated_roughness,
        rfilter_kind=scene.rfilter.kind,
        rfilter_radius=scene.rfilter.radius,
        rfilter_stddev=scene.rfilter.stddev,
        rfilter_b=scene.rfilter.b,
        rfilter_c=scene.rfilter.c,
        pixel_cone=float(2.0 * np.tan(np.deg2rad(cam.fov) / 2.0) / cam.height),
    )
    return arrays, static


def _static_from_fields(fields: dict) -> SceneStatic:
    """SceneStatic from a field dict (the port's or kazen_tpu's), refusing
    what the slice has not ported."""
    if fields.get("has_image_textures") or fields.get("has_composite_textures"):
        raise NotImplementedError(
            "image and composite textures are not ported to kazen_tpu_torch yet"
        )
    if fields.get("env_importance"):
        raise NotImplementedError(
            "environment importance sampling is not ported to kazen_tpu_torch yet"
        )
    if fields.get("integrator_kind", "path_mis") != "path_mis":
        raise NotImplementedError(
            f"integrator {fields['integrator_kind']!r} is not ported to "
            "kazen_tpu_torch yet"
        )
    if fields["sampler_kind"] not in SAMPLER_KINDS:
        raise NotImplementedError(
            f"the {fields['sampler_kind']} sampler is not ported to "
            "kazen_tpu_torch yet"
        )
    bad = [t for t in fields["btypes_present"] if t not in PORTED_BTYPES]
    if bad:
        raise NotImplementedError(
            f"material types {bad} are not ported to kazen_tpu_torch yet "
            "(diffuse, lambertian, mirror, dielectric, ggx and kiss only)"
        )
    names = {f.name for f in dataclasses.fields(SceneStatic)}
    return SceneStatic(
        **{k: (tuple(v) if k == "btypes_present" else v)
           for k, v in fields.items() if k in names}
    )


def _face_meta(arrays: dict, n_lights: int):
    """Per-face light id / light primary visibility / material / has_n /
    has_uv, as the reference's compiler derives them for packing."""
    fm = np.asarray(arrays["face_mesh"])
    lid_face = np.asarray(arrays["mesh_light"], np.int32)[fm]
    if n_lights:
        lpv = np.asarray(arrays["light_primary_vis"][:n_lights], bool)
        lpv_face = np.where(lid_face >= 0, lpv[np.maximum(lid_face, 0)], False)
    else:
        lpv_face = np.zeros(len(fm), bool)
    return (
        lid_face,
        lpv_face,
        np.asarray(arrays["mesh_material"], np.int32)[fm],
        np.asarray(arrays["mesh_has_normals"], bool)[fm],
        np.asarray(arrays["mesh_has_uvs"], bool)[fm],
    )


def scene_from_numpy(
    arrays: dict, static_fields: dict, device, megakernel: Optional[bool] = None,
) -> "tuple[SceneArrays, SceneStatic]":
    """(SceneArrays, SceneStatic) on ``device`` from a compiled scene given as
    numpy: ``arrays`` holds SceneArrays' fields by name (``materials`` and
    ``trace_tables`` as dicts of arrays, bf16 already converted to f32; a
    missing or None ``trace_tables`` is packed here), ``static_fields``
    holds SceneStatic's fields. kazen_tpu's compiled scene converts to this
    form field by field, which is how the tests feed both packages one
    scene.

    The megakernel's tables are packed here for a scene in its class.
    ``megakernel`` picks the route render() takes for such a scene: None
    takes the megakernel on CUDA and the wavefront on the CPU (the
    reference's default off its accelerator), True and False force it. True
    on a scene outside the class raises."""
    device = resolve_device(device)
    static = _static_from_fields(static_fields)

    def f32(name):
        return torch.tensor(np.asarray(arrays[name], np.float32), device=device)

    def i64(name):
        return torch.tensor(np.asarray(arrays[name], np.int64), device=device)

    def flag(name):
        return torch.tensor(np.asarray(arrays[name], bool), device=device)

    mats = arrays["materials"]
    materials = MaterialTable(
        **{
            f.name: torch.tensor(
                np.asarray(
                    mats[f.name],
                    np.int64 if f.name in _MATERIAL_INT else np.float32,
                ),
                device=device,
            )
            for f in dataclasses.fields(MaterialTable)
        }
    )
    tt = arrays.get("trace_tables")
    if tt is None:
        tables = ct.pack_cluster_tables(
            arrays["V"], arrays["F"], arrays["face_shade"],
            *_face_meta(arrays, static.num_lights), device=device,
        )
    else:
        tables = ct.tables_from_numpy(
            tt["node_scalars"], tt["geo_shade"], tt["leaf_bounds"],
            tt.get("builder", "given"), device,
        )
    scene = SceneArrays(
        V=f32("V"), F=i64("F"), N=f32("N"), UV=f32("UV"),
        face_shade=f32("face_shade"), face_mesh=i64("face_mesh"),
        mesh_material=i64("mesh_material"), mesh_light=i64("mesh_light"),
        mesh_has_normals=flag("mesh_has_normals"),
        mesh_has_uvs=flag("mesh_has_uvs"),
        materials=materials,
        light_mesh=i64("light_mesh"), light_radiance=f32("light_radiance"),
        light_primary_vis=flag("light_primary_vis"),
        light_cdf=f32("light_cdf"), light_faces=i64("light_faces"),
        light_inv_area=f32("light_inv_area"),
        bg_color=f32("bg_color"), bg_intensity=f32("bg_intensity"),
        cam_to_world=f32("cam_to_world"),
        sample_to_camera=f32("sample_to_camera"),
        cam_near=f32("cam_near"), cam_far=f32("cam_far"),
        aperture_radius=f32("aperture_radius"),
        focus_distance=f32("focus_distance"),
        trace_tables=tables,
    )
    return _with_megakernel(scene, static, megakernel)


def _with_megakernel(scene: SceneArrays, static: SceneStatic, megakernel):
    """Pack the megakernel's tables for a scene in its class and set
    ``use_megakernel`` (see scene_from_numpy)."""
    from ..integrate import megakernel as mk

    ok, reason = mk.supported_reason(scene, static)
    if not ok:
        if megakernel:
            raise ValueError(f"the scene is outside the megakernel's class: {reason}")
        return scene, dataclasses.replace(static, use_megakernel=False, mega_cfg=None)
    enable = scene.device.type == "cuda" if megakernel is None else bool(megakernel)
    scene = dataclasses.replace(scene, mega=mk.pack_tables(scene, static))
    return scene, dataclasses.replace(
        static, use_megakernel=enable, mega_cfg=mk.cfg_key(scene, static)
    )


def compile_scene(
    scene: D.Scene, device="cuda", megakernel: Optional[bool] = None,
) -> "tuple[SceneArrays, SceneStatic]":
    """Compile a scene description onto ``device`` (CUDA unless the caller
    asks for the CPU). ``megakernel`` picks render()'s route for a scene in
    the megakernel's class, as scene_from_numpy says."""
    device = resolve_device(device)
    arrays, static = compile_numpy(scene)
    return scene_from_numpy(arrays, static, device, megakernel)
