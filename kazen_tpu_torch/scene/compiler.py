"""Scene compiler: lowers the scene description to flat tensors.

The port of ``kazen_tpu/scene/compiler.py``: inline meshes; every material
of the reference (diffuse, lambertian, mirror, dielectric, GGX,
roughconductor, roughplastic, roughdielectric, kiss, and the normalmap
wrapper); constant, image and composite textures, with box-filtered mip
chains when the scene asks for mip filtering; area lights; a constant or
textured background with optional importance tables; perspective and
thinlens cameras; the path_mis, normals, ao, whitted and path_mats
integrators; the independent, stratified, correlated and pmj02bn samplers.
Meshes are inline arrays or OBJ files (scene/obj.py); image textures are
``data`` arrays or PNG/EXR files (film/io.py:load_image, scaled as the
reference scales what imageio reads). scene/xml_io.py reads a scene file.

The result is ``(SceneArrays, SceneStatic)``: a dataclass of tensors on one
device and a frozen dataclass of Python values. Cluster trace tables are
always packed, whatever the scene's size. A scene in the megakernel's class
(integrate/megakernel.py:supported_reason: at most 128 faces, 16 materials
and 64 light triangles, constant textures) also gets the megakernel's
tables, and on CUDA ``use_megakernel``: render() then runs the whole path
of a lane in one kernel, as the reference does on its accelerator. A
scene in the shade kernel's class (shade/bounce_kernel.py:supported_reason)
gets its material and light tables. ``scene_from_numpy`` builds the same pair from kazen_tpu's compiled scene
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
from ..utils import metrics
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

# Conductor Fresnel presets (eta, k) per channel (bsdf.cpp:703-713)
CONDUCTORS = {
    "Au": ((0.1431889, 0.3749570, 1.4424879), (3.9831604, 2.3857207, 1.6032152)),
    "Cu": ((0.2004376, 0.9240334, 1.1022119), (3.9129485, 2.4528477, 2.1421879)),
    "Cr": ((4.3696842, 2.9167024, 1.6547005), (5.2064351, 4.2313262, 3.7549467)),
}

TEX_IMAGE = 0
TEX_CONSTANT = 1
TEX_COLORRAMP = 2
TEX_BLEND_MIX = 3
TEX_BLEND_MULTIPLY = 4

MAX_MIP_LEVELS = 14  # up to 8192^2 level-0 images
ENV_TABLE_RES = (256, 512)  # (Eh, Ew) of the lat-long importance tables


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
        """Per-lane material rows for material ids ``idx`` (a 1-D lane
        tensor). index_select, whose backward adds with index_add_: the
        backward of indexing sorts the lanes' ids and serializes the runs of
        equal ones, which many lanes on few materials make slow on CUDA."""
        return MaterialTable(**{
            f.name: torch.index_select(getattr(self, f.name), 0, idx)
            for f in dataclasses.fields(self)
        })


_MATERIAL_INT = {"btype", "tex_base", "tex_metallic", "tex_roughness", "nested", "tex_normal"}
# a material's texture fields: the lookups of shade/bsdf.py by name, each
# with its texture id column
TEXTURE_FIELDS = {"base": "tex_base", "metallic": "tex_metallic",
                  "roughness": "tex_roughness", "normal": "tex_normal"}


@dataclass
class TexturePool:
    """The flat texture graph: image nodes index the texel pool, composite
    nodes (colorramp texture.cpp:149-191, blend :195-270) name child nodes,
    at most 2 composite levels deep. With mip filtering every image node
    has a box-filtered chain in the same pool: level l at mip_offset[:, l],
    of size max(1, w >> l) x max(1, h >> l)."""

    texels: torch.Tensor  # (P, 3) float32
    offset: torch.Tensor  # (T,) int64 level-0 start in texels
    width: torch.Tensor  # (T,) int64 (level 0)
    height: torch.Tensor  # (T,) int64
    uv_scale: torch.Tensor  # (T,)
    ttype: torch.Tensor  # (T,) int64 TEX_*
    const_color: torch.Tensor  # (T, 3)
    input1: torch.Tensor  # (T,) int64 input/input1 node, -1 absent
    input2: torch.Tensor  # (T,) int64
    mask_id: torch.Tensor  # (T,) int64
    ramp_min: torch.Tensor  # (T,)
    ramp_max: torch.Tensor  # (T,)
    mip_offset: torch.Tensor  # (T, MAX_MIP_LEVELS) int64
    n_levels: torch.Tensor  # (T,) int64 (1 = no chain)


_TEX_FLOAT = {"texels", "uv_scale", "const_color", "ramp_min", "ramp_max"}


def _pool_to_device(pool: dict, device) -> TexturePool:
    return TexturePool(**{
        f.name: torch.tensor(
            np.asarray(pool[f.name], np.float32 if f.name in _TEX_FLOAT else np.int64),
            device=device,
        )
        for f in dataclasses.fields(TexturePool)
    })


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
    textures: TexturePool
    light_mesh: torch.Tensor  # (L,) int64
    light_radiance: torch.Tensor  # (L, 3)
    light_primary_vis: torch.Tensor  # (L,) bool
    light_cdf: torch.Tensor  # (L, maxLF + 1) normalized area CDF
    light_faces: torch.Tensor  # (L, maxLF) int64 global face ids
    light_inv_area: torch.Tensor  # (L,)
    bg_color: torch.Tensor  # (3,)
    bg_tex: torch.Tensor  # () int64, -1 = the constant bg_color
    bg_intensity: torch.Tensor  # ()
    cam_to_world: torch.Tensor  # (4, 4)
    sample_to_camera: torch.Tensor  # (4, 4)
    cam_near: torch.Tensor  # ()
    cam_far: torch.Tensor  # ()
    aperture_radius: torch.Tensor  # ()
    focus_distance: torch.Tensor  # ()
    trace_tables: ct.ClusterTables
    # environment importance tables (placeholders without importance)
    env_row_cdf: torch.Tensor  # (Eh + 1,) row marginal CDF
    env_col_cdf: torch.Tensor  # (Eh, Ew + 1) per-row conditional CDF
    env_pdf: torch.Tensor  # (Eh, Ew) solid-angle pdf per texel
    mega: Optional[object] = None  # integrate/megakernel.py:MegaTables
    shade_tables: Optional[object] = None  # shade/bounce_kernel.py:ShadeTables

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
    has_composite_textures: bool  # any colorramp or blend node
    has_image_textures: bool  # any image node
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
    env_importance: bool = False  # Background.importance
    env_res: Tuple[int, int] = (0, 0)  # (Eh, Ew) of the importance tables
    mip_textures: bool = False  # trilinear mip filtering (Scene.mip_textures)
    aniso_textures: bool = True  # EWA probes along the footprint's major axis
    pixel_cone: float = 0.0  # one pixel's footprint angle, for the mip level
    use_megakernel: bool = False  # render() takes integrate/megakernel.py
    mega_cfg: Optional[Tuple] = None  # the megakernel's static config
    # the material texture fields (TEXTURE_FIELDS) that some material names a
    # texture in, derived from the material table by scene_from_numpy
    textured_fields: Tuple[str, ...] = ()


class _TexturePacker:
    """Texture graph nodes and the texel pool, on the host."""

    def __init__(self, build_mips: bool = False):
        self.build_mips = build_mips
        self.texels = []
        self.total = 0
        self.nodes = []  # one dict of TexturePool's per-node fields each

    def _new_node(self, ttype, const=(0.0, 0.0, 0.0)) -> int:
        self.nodes.append(dict(
            ttype=ttype, const_color=np.asarray(const, np.float32), input1=-1, input2=-1,
            mask_id=-1, ramp_min=0.0, ramp_max=1.0, offset=0, width=1, height=1,
            uv_scale=1.0, mip_offset=[0] * MAX_MIP_LEVELS, n_levels=1,
        ))
        return len(self.nodes) - 1

    def add_node(self, tex, depth=0) -> int:
        """Register any texture graph node; returns its id."""
        tex = D.as_texture(tex)
        if isinstance(tex, D.ImageTexture):
            return self.add(tex)
        if isinstance(tex, D.ConstantTexture):
            return self._new_node(TEX_CONSTANT, tex.color)
        if depth >= 2:
            raise ValueError("texture graphs deeper than 2 composite levels")
        if isinstance(tex, D.ColorRamp):
            tid = self._new_node(TEX_COLORRAMP)
            node = self.nodes[tid]
            if tex.input is not None:
                node["input1"] = self.add_node(tex.input, depth + 1)
            node["ramp_min"] = float(tex.min)
            node["ramp_max"] = float(tex.max)
            return tid
        if isinstance(tex, D.Blend):
            tid = self._new_node(TEX_BLEND_MIX if tex.mode == "mix" else TEX_BLEND_MULTIPLY)
            node = self.nodes[tid]
            if tex.mask is not None:
                node["mask_id"] = self.add_node(tex.mask, depth + 1)
            if tex.input1 is not None:
                node["input1"] = self.add_node(tex.input1, depth + 1)
            if tex.input2 is not None:
                node["input2"] = self.add_node(tex.input2, depth + 1)
            return tid
        raise TypeError(f"unknown texture node {type(tex).__name__}")

    def add(self, tex: D.ImageTexture) -> int:
        if tex.data is not None:
            img = np.asarray(tex.data, np.float32)
        else:
            img = read_texture_file(tex.filename)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        img = img[..., :3]
        if tex.colorspace == "srgb":
            img = np.where(
                img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
            ).astype(np.float32)
        h, w = img.shape[:2]
        tid = self._new_node(TEX_IMAGE)
        node = self.nodes[tid]
        node.update(offset=self.total, width=w, height=h, uv_scale=float(tex.scale))
        self.texels.append(img.reshape(-1, 3).astype(np.float32))
        node["mip_offset"][0] = self.total
        self.total += h * w
        if self.build_mips:
            # 2x2 box-filtered chain down to 1x1 (OIIO's filtered
            # minification, texture.cpp:46-64, computed ahead); odd sizes
            # wrap their last row or column (textures are periodic)
            level = img.astype(np.float32)
            li = 1
            while (level.shape[0] > 1 or level.shape[1] > 1) and li < MAX_MIP_LEVELS:
                hh, ww = level.shape[:2]
                if hh % 2:
                    level = np.concatenate([level, level[:1]], axis=0)
                if ww % 2:
                    level = np.concatenate([level, level[:, :1]], axis=1)
                level = 0.25 * (
                    level[0::2, 0::2] + level[1::2, 0::2] + level[0::2, 1::2]
                    + level[1::2, 1::2]
                )
                node["mip_offset"][li] = self.total
                self.texels.append(level.reshape(-1, 3).astype(np.float32))
                self.total += level.shape[0] * level.shape[1]
                li += 1
            node["n_levels"] = li
            for rest in range(li, MAX_MIP_LEVELS):
                node["mip_offset"][rest] = node["mip_offset"][li - 1]
        return tid

    def finish(self) -> dict:
        """The pool as numpy arrays, by TexturePool's field names."""
        if not self.nodes:
            self._new_node(TEX_CONSTANT)
        out = {
            name: np.asarray(
                [nd[name] for nd in self.nodes],
                np.float32 if name in _TEX_FLOAT else np.int32,
            )
            for name in self.nodes[0]
        }
        out["texels"] = (
            np.concatenate(self.texels, axis=0) if self.texels else np.zeros((1, 3), np.float32)
        )
        return out

    def flags(self):
        """(has composite nodes, has image nodes)."""
        types = [nd["ttype"] for nd in self.nodes]
        return any(t >= TEX_COLORRAMP for t in types), any(t == TEX_IMAGE for t in types)


class _MaterialBuilder:
    """Material table rows with the reference's defaults; a normalmap adds
    its nested material's row first."""

    def __init__(self, packer: _TexturePacker):
        self.rows = []
        self.packer = packer

    def _tex_or_const(self, tex):
        """(constant rgb, texture id); a plain constant needs no node."""
        tex = D.as_texture(tex)
        if isinstance(tex, D.ConstantTexture):
            return np.asarray(tex.color, np.float32), -1
        return np.ones(3, np.float32), self.packer.add_node(tex)

    @staticmethod
    def _blank() -> dict:
        return dict(
            btype=BSDF_DIFFUSE,
            base_color=np.asarray([0.5, 0.5, 0.5], np.float32),
            tex_base=-1, metallic=0.0, tex_metallic=-1, roughness=0.5,
            tex_roughness=-1, anisotropy=0.0, specular=0.5, specular_tint=0.5,
            clearcoat=0.0, clearcoat_roughness=0.5, sheen=0.0, sheen_tint=0.5,
            int_ior=1.5046, ext_ior=1.000277, alpha=0.1,
            eta_c=np.zeros(3, np.float32), k_c=np.zeros(3, np.float32),
            nested=-1, tex_normal=-1,
        )

    def add(self, b: Optional[D.BSDF]) -> int:
        if b is None:
            b = D.Diffuse()  # default material (mesh.cpp:25-28)
        row = self._blank()
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
            row["base_color"], row["tex_base"] = self._tex_or_const(b.albedo)
        elif isinstance(b, D.GGX):
            row["btype"] = BSDF_GGX
            row["base_color"], row["tex_base"] = self._tex_or_const(b.albedo)
            row["roughness"] = b.roughness
            row["anisotropy"] = b.anisotropy
        elif isinstance(b, D.RoughConductor):
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
        elif isinstance(b, D.RoughDielectric):
            row["btype"] = BSDF_ROUGHDIELECTRIC
            row["alpha"] = max(1e-3, b.roughness**2)
            row["int_ior"] = b.int_ior
            row["ext_ior"] = b.ext_ior
        elif isinstance(b, D.KazenStandard):
            row["btype"] = BSDF_KISS
            row["base_color"], row["tex_base"] = self._tex_or_const(b.base_color)
            mc, mt = self._tex_or_const(b.metallic)
            row["metallic"], row["tex_metallic"] = float(mc[0]), mt
            rc, rt = self._tex_or_const(b.roughness)
            row["roughness"], row["tex_roughness"] = float(rc[0]), rt
            for k in ("anisotropy", "specular", "specular_tint", "clearcoat",
                      "clearcoat_roughness", "sheen", "sheen_tint"):
                row[k] = getattr(b, k)
        elif isinstance(b, D.NormalMap):
            nested_id = self.add(b.nested)
            row = self._blank()
            row["btype"] = BSDF_NORMALMAP
            row["nested"] = nested_id
            _, row["tex_normal"] = self._tex_or_const(b.normals)
        else:
            raise TypeError(f"unknown BSDF {type(b).__name__}")
        self.rows.append(row)
        return len(self.rows) - 1


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


def read_texture_file(path: str) -> np.ndarray:
    """A texture file's pixels as float32, scaled by the reference's rule
    (kazen_tpu/scene/compiler.py:282-286): divided by 255 when the largest
    value exceeds 1.5 after the cast to float32, whatever the file's bit
    depth or format. A gray+alpha image keeps its gray channel (the
    reference's path fails on it)."""
    from ..film.io import load_image

    img = np.asarray(load_image(path), np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 3 and img.shape[-1] == 2:
        img = img[..., 0]
    return img


def _mesh_arrays(m: D.Mesh):
    if m.filename is not None:
        from .obj import load_obj

        return load_obj(m.filename, m.to_world)
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


def _build_env_tables(pool: dict, bg_tex, bg_color, bg_intensity, has_comp, has_img):
    """Rasterize the background onto a lat-long luminance grid and build the
    row marginal and per-row conditional CDFs and the solid-angle pdf of
    each texel (a pbrt-style 2D distribution). The pdf has a 1% floor of the
    mean luminance, so that a texel the rasterization underrates keeps a
    nonzero probability (the estimator stays unbiased). The lookup runs on
    the CPU; the arithmetic after it is the reference's, in numpy."""
    from types import SimpleNamespace

    from ..shade.textures import eval_texture_dir

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
    if isinstance(integ, D.PathMis):
        integrator = dict(
            integrator_kind="path_mis", max_depth=min(512, integ.max_depth),
            trace_bias=integ.trace_bias, regularization=integ.regularization,
            accumulated_roughness=integ.accumulated_roughness,
        )
    else:
        integrator = dict(
            integrator_kind=integ.kind, max_depth=integ.max_depth, trace_bias=1e-3,
            regularization=False, accumulated_roughness=0.5,
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
        env_importance=env_importance,
        env_res=ENV_TABLE_RES if env_importance else (0, 0),
        mip_textures=bool(scene.mip_textures),
        aniso_textures=bool(getattr(scene, "aniso_textures", True)),
        pixel_cone=float(2.0 * np.tan(np.deg2rad(cam.fov) / 2.0) / cam.height),
    )
    return arrays, static


_INTEGRATORS = ("path_mis", "normals", "ao", "whitted", "path_mats")


def textured_fields_of(materials) -> Tuple[str, ...]:
    """The texture fields (TEXTURE_FIELDS, in its order) that some row of a
    material table, given as arrays by column name, names a texture in."""
    return tuple(field for field, col in TEXTURE_FIELDS.items()
                 if (np.asarray(materials[col]) >= 0).any())


def _static_from_fields(fields: dict) -> SceneStatic:
    """SceneStatic from a field dict (the port's or kazen_tpu's)."""
    if fields.get("integrator_kind", "path_mis") not in _INTEGRATORS:
        raise ValueError(f"unknown integrator {fields['integrator_kind']!r}")
    if fields["sampler_kind"] not in SAMPLER_KINDS:
        raise ValueError(f"unknown sampler kind {fields['sampler_kind']!r}")
    names = {f.name for f in dataclasses.fields(SceneStatic)}
    return SceneStatic(
        **{k: (tuple(v) if k in ("btypes_present", "env_res") else v)
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
    numpy: ``arrays`` holds SceneArrays' fields by name (``materials``,
    ``textures`` and ``trace_tables`` as dicts of arrays, bf16 already
    converted to f32; a missing or None ``trace_tables`` is packed here), ``static_fields``
    holds SceneStatic's fields (``textured_fields`` is derived here, from the
    material table). kazen_tpu's compiled scene converts to this
    form field by field, which is how the tests feed both packages one
    scene.

    The megakernel's tables, and the shade kernel's, are packed here for a
    scene in their class.
    ``megakernel`` picks the route render() takes for such a scene: None
    takes the megakernel on CUDA and the wavefront on the CPU (the
    reference's default off its accelerator), True and False force it. True
    on a scene outside the class raises."""
    device = resolve_device(device)
    static = dataclasses.replace(_static_from_fields(static_fields),
                                 textured_fields=textured_fields_of(arrays["materials"]))

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
        textures=_pool_to_device(arrays["textures"], device),
        light_mesh=i64("light_mesh"), light_radiance=f32("light_radiance"),
        light_primary_vis=flag("light_primary_vis"),
        light_cdf=f32("light_cdf"), light_faces=i64("light_faces"),
        light_inv_area=f32("light_inv_area"),
        bg_color=f32("bg_color"), bg_tex=i64("bg_tex"), bg_intensity=f32("bg_intensity"),
        cam_to_world=f32("cam_to_world"),
        sample_to_camera=f32("sample_to_camera"),
        cam_near=f32("cam_near"), cam_far=f32("cam_far"),
        aperture_radius=f32("aperture_radius"),
        focus_distance=f32("focus_distance"),
        trace_tables=tables,
        env_row_cdf=f32("env_row_cdf"), env_col_cdf=f32("env_col_cdf"),
        env_pdf=f32("env_pdf"),
    )
    from ..shade import bounce_kernel

    if bounce_kernel.supported_reason(scene, static)[0]:
        scene = dataclasses.replace(scene, shade_tables=bounce_kernel.pack_tables(scene))
    return _with_megakernel(scene, static, megakernel)


def _with_megakernel(scene: SceneArrays, static: SceneStatic, megakernel):
    """Pack the megakernel's tables for a scene in its class and set
    ``use_megakernel`` (see scene_from_numpy)."""
    from ..integrate import megakernel as mk

    ok, reason = mk.supported_reason(scene, static)
    if not ok:
        if megakernel:
            raise ValueError(f"the scene is outside the megakernel's class: {reason}")
        if static.integrator_kind == "path_mis" and scene.F.shape[0] <= mk.MAX_BRUTE:
            # a small scene that would otherwise take the megakernel: make
            # the fall-back visible, as the reference does
            from ..utils.metrics import LOG

            LOG(f"megakernel fast path declined ({reason}); using the wavefront + "
                "cluster trace")
        return scene, dataclasses.replace(static, use_megakernel=False, mega_cfg=None)
    enable = scene.device.type == "cuda" if megakernel is None else bool(megakernel)
    scene = dataclasses.replace(scene, mega=mk.pack_tables(scene, static))
    return scene, dataclasses.replace(
        static, use_megakernel=enable, mega_cfg=mk.cfg_key(scene, static)
    )


@metrics.traced("compile_scene")
def compile_scene(
    scene: D.Scene, device="cuda", megakernel: Optional[bool] = None,
) -> "tuple[SceneArrays, SceneStatic]":
    """Compile a scene description onto ``device`` (CUDA unless the caller
    asks for the CPU). ``megakernel`` picks render()'s route for a scene in
    the megakernel's class, as scene_from_numpy says."""
    device = resolve_device(device)
    arrays, static = compile_numpy(scene)
    return scene_from_numpy(arrays, static, device, megakernel)
