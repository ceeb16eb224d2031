"""The scene description of configuration 3: the classes of
``kz/scene/description.py``, and the two that configuration 3 adds, frozen
copies of the port's ``scene/description.py`` ``NormalMap`` and
``ThinlensCamera``."""
from __future__ import annotations

from dataclasses import dataclass

from ..kz.scene.description import (  # noqa: F401 (the description's classes)
    BSDF,
    AreaLight,
    Background,
    ConstantTexture,
    Diffuse,
    GGX,
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
class NormalMap:
    """normalmap wrapper (bsdf.cpp:281-417): perturbs the shading frame from
    a tangent-space normal texture, delegates to the nested BSDF."""

    nested: BSDF = None
    normals: Texture = None


@dataclass
class ThinlensCamera(PerspectiveCamera):
    aperture_radius: float = 1.0
    focus_distance: float = 0.0
