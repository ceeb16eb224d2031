"""The scene description of the Textured configuration: the classes of
``kz/scene/description.py`` and ``con1/``'s normal map, and the ones
Textured adds, frozen copies of the port's ``scene/description.py``
``RoughConductor``, ``RoughPlastic``, ``RoughDielectric`` and the
``Background`` with its ``importance`` flag."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..con1.description import NormalMap  # noqa: F401 (the description's classes)
from ..kz.scene.description import (  # noqa: F401
    BSDF,
    AreaLight,
    ConstantTexture,
    Diffuse,
    ImageTexture,
    KazenStandard,
    Mesh,
    PathMis,
    PerspectiveCamera,
    RFilter,
    Sampler,
    Scene,
    Texture,
    as_texture,
    lookat,
)


@dataclass
class RoughConductor:
    """roughconductor (bsdf.cpp:692-811): Beckmann microfacet conductor;
    alpha_eff = max(1e-3, alpha^2) (bsdf.cpp:695-700)."""

    material: str = "Au"  # Au / Cu / Cr conductor presets
    alpha: float = 0.1


@dataclass
class RoughPlastic:
    """roughplastic (bsdf.cpp:814-943): Beckmann specular + Lambertian base;
    same alpha squaring as roughconductor."""

    alpha: float = 0.1
    int_ior: float = 1.5046
    ext_ior: float = 1.000277
    kd: Tuple[float, float, float] = (0.5, 0.5, 0.5)


@dataclass
class RoughDielectric:
    """roughdielectric (bsdf.cpp:947-1145): rough glass, reflect+refract;
    alpha_eff = max(1e-3, roughness^2) (bsdf.cpp:956-959)."""

    roughness: float = 0.1
    int_ior: float = 1.5046
    ext_ior: float = 1.000277


@dataclass
class Background:
    """background (texture.cpp:104-145): intensity x nested texture;
    ``importance`` samples the environment in NEE and MIS-weights escaped
    BSDF rays against its pdf."""

    texture: "Texture" = None
    intensity: float = 1.0
    importance: bool = False
