"""User-facing scene description: dataclasses mirroring the reference's XML
schema semantics and defaults (SURVEY §2.9, parser.cpp:73-97, plus the
per-plugin defaults noted in SURVEY §5).

A frozen copy of the port's description, cut to the classes the
benchmark's configurations use. This layer is host-side Python only;
``scene.compiler`` lowers it to the flat ``SceneArrays`` pytree that the
wavefront integrator consumes. Parameter names and defaults match the
reference so its scenes convert 1:1
(e.g. camera defaults 1280x720 fov=30, camera.cpp:18-26; area light
intensity=1 primaryVisibility=false, light.cpp:10-12; path_mis defaults
integrator.cpp:189-192).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Textures (texture.cpp)
# ---------------------------------------------------------------------------


@dataclass
class ConstantTexture:
    """constanttexture (texture.cpp:10-32)."""

    color: Tuple[float, float, float] = (0.5, 0.5, 0.5)


@dataclass
class ImageTexture:
    """imagetexture (texture.cpp:36-98): periodic wrap, v-flip, uv scale,
    srgb->linear conversion at load."""

    filename: Optional[str] = None
    data: Optional[np.ndarray] = None  # (H, W, 3) float or uint8 alternative
    scale: float = 1.0
    colorspace: str = "srgb"  # "srgb" converts to linear at load


@dataclass
class Background:
    """background (texture.cpp:104-145): intensity x nested texture,
    evaluated on escape only (scene.cpp:54-79)."""

    texture: "Texture" = None
    intensity: float = 1.0


Texture = Union[ConstantTexture, ImageTexture]


def as_texture(v) -> Texture:
    if isinstance(v, (ConstantTexture, ImageTexture)):
        return v
    if isinstance(v, (int, float)):
        return ConstantTexture((float(v),) * 3)
    if isinstance(v, (tuple, list, np.ndarray)):
        return ConstantTexture(tuple(float(x) for x in v))
    raise TypeError(f"cannot interpret {v!r} as a texture")


# ---------------------------------------------------------------------------
# BSDFs (bsdf.cpp registrations; defaults from each ctor)
# ---------------------------------------------------------------------------


@dataclass
class Diffuse:
    """diffuse (bsdf.cpp:20-92): Lambertian with constant albedo."""

    albedo: Tuple[float, float, float] = (0.5, 0.5, 0.5)


@dataclass
class GGX:
    """ggx (bsdf.cpp:629-689): GGX-Smith VNDF BRDF with textured albedo."""

    albedo: Texture = field(default_factory=ConstantTexture)
    roughness: float = 0.1
    anisotropy: float = 0.0


@dataclass
class KazenStandard:
    """kazenstandard / 'kiss' (bsdf.cpp:1157-1418): Disney-style uber BRDF
    (diffuse+retro, sheen, GGX-VNDF specular, clearcoat); textured
    baseColor/metallic/roughness children (addChild bsdf.cpp:1373-1395)."""

    base_color: Texture = field(default_factory=lambda: ConstantTexture((0.8, 0.8, 0.8)))
    metallic: Texture = field(default_factory=lambda: ConstantTexture((0.0, 0.0, 0.0)))
    roughness: Texture = field(default_factory=lambda: ConstantTexture((0.5, 0.5, 0.5)))
    anisotropy: float = 0.0
    specular: float = 0.5
    specular_tint: float = 0.5
    clearcoat: float = 0.0
    clearcoat_roughness: float = 0.5
    sheen: float = 0.0
    sheen_tint: float = 0.5


BSDF = Union[Diffuse, GGX, KazenStandard]


# ---------------------------------------------------------------------------
# Lights (light.cpp)
# ---------------------------------------------------------------------------


@dataclass
class AreaLight:
    """area (light.cpp:7-66)."""

    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    primary_visibility: bool = False


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@dataclass
class Mesh:
    """A triangle mesh: either loaded from OBJ or given inline arrays.

    ``to_world`` is applied at load like the reference OBJ loader
    (mesh.cpp:210-245: points by M, normals by inverse-transpose).
    """

    filename: Optional[str] = None
    vertices: Optional[np.ndarray] = None  # (V, 3)
    faces: Optional[np.ndarray] = None  # (F, 3) int
    normals: Optional[np.ndarray] = None  # (V, 3) or None
    uvs: Optional[np.ndarray] = None  # (V, 2) or None
    to_world: Optional[np.ndarray] = None  # (4, 4)
    bsdf: Optional[BSDF] = None  # defaults to diffuse (mesh.cpp:25-28)
    light: Optional[AreaLight] = None


# ---------------------------------------------------------------------------
# Cameras (camera.cpp)
# ---------------------------------------------------------------------------


@dataclass
class PerspectiveCamera:
    width: int = 1280
    height: int = 720
    to_world: Optional[np.ndarray] = None  # (4, 4)
    fov: float = 30.0
    near_clip: float = 1e-4
    far_clip: float = 1e4


Camera = PerspectiveCamera


# ---------------------------------------------------------------------------
# Integrator / sampler / filter configs
# ---------------------------------------------------------------------------


@dataclass
class PathMis:
    """path_mis (integrator.cpp:185-355)."""

    max_depth: int = 5
    trace_bias: float = 1e-3
    regularization: bool = False
    accumulated_roughness: float = 0.5


Integrator = PathMis


@dataclass
class Sampler:
    kind: str = "independent"
    sample_count: int = 1
    seed: int = 1


@dataclass
class RFilter:
    """gaussian (default, rfilter.cpp) / mitchell / tent / box."""

    kind: str = "gaussian"
    radius: float = 2.0
    stddev: float = 0.5
    b: float = 1.0 / 3.0
    c: float = 1.0 / 3.0


# ---------------------------------------------------------------------------
# Scene root
# ---------------------------------------------------------------------------


@dataclass
class Scene:
    meshes: List[Mesh] = field(default_factory=list)
    camera: Camera = field(default_factory=PerspectiveCamera)
    sampler: Sampler = field(default_factory=Sampler)
    integrator: Integrator = field(default_factory=PathMis)
    rfilter: RFilter = field(default_factory=RFilter)
    background: Optional[Background] = None
    # Filtered (trilinear mip) image-texture minification, the analog of
    # OIIO's filtered lookups (texture.cpp:46-64) and therefore the default
    # (the reference always filters). Set False for level-0 bilinear, the
    # scalar-oracle parity mode.
    mip_textures: bool = True
    # EWA-style anisotropic minification (probes along the footprint's
    # major axis at the minor-axis mip level); False = round-4 isotropic
    # conservative footprint (min |dpdu|,|dpdv| -> over-blurs grazing)
    aniso_textures: bool = True


def lookat(origin, target, up) -> np.ndarray:
    """Build a camera-to-world matrix from lookat (parser.cpp:251-277)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    dirv = target - origin
    dirv /= np.linalg.norm(dirv)
    left = np.cross(up / np.linalg.norm(up), dirv)
    left /= np.linalg.norm(left)
    new_up = np.cross(dirv, left)
    new_up /= np.linalg.norm(new_up)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = dirv
    m[:3, 3] = origin
    return m
