"""Scene parameters as leaves and the image loss: the frozen subset of the
program's ``diff/inverse.py`` that the reference's gradient step needs.
Parameters are named ``materials.<field>`` (the material table's float
fields). Adam with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8); after each step base_color, metallic and roughness are clipped
to [0, 1]."""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..core import rng
from ..film import film as film_mod
from ..integrate.render import pixel_grid, render_pass

MATERIAL_FLOAT_FIELDS = (
    "base_color", "metallic", "roughness", "anisotropy", "specular", "specular_tint",
    "clearcoat", "clearcoat_roughness", "sheen", "sheen_tint", "int_ior", "ext_ior",
    "alpha", "eta_c", "k_c",
)
_UNIT_FIELDS = ("base_color", "metallic", "roughness")


def get_params(arrays, keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The parameter groups ``keys`` (only "materials") as new leaves, by
    name."""
    if tuple(keys) != ("materials",):
        raise ValueError(f"the reference fits the material table only, not {keys}")
    out = {f"materials.{k}": getattr(arrays.materials, k) for k in MATERIAL_FLOAT_FIELDS}
    return {k: v.detach().clone().requires_grad_(True) for k, v in out.items()}


def apply_params(arrays, params: Dict):
    mats = {k.split(".", 1)[1]: v for k, v in params.items() if k.startswith("materials.")}
    if mats:
        arrays = dataclasses.replace(arrays,
                                     materials=dataclasses.replace(arrays.materials, **mats))
    return arrays


def render_image(arrays, static, spec, params: Dict, sample_indices) -> torch.Tensor:
    """The image of ``sample_indices``' passes with ``params`` swapped in:
    differentiable with respect to them."""
    sc = apply_params(arrays, params)
    px, py = pixel_grid(static, arrays.device)
    film = film_mod.make_film(static, arrays.device)
    for s in sample_indices:
        film = render_pass(sc, static, spec, film, px, py, s, rng.advance_constants(s * 65536))
    return film_mod.to_bitmap(film)


def image_loss(img, target) -> torch.Tensor:
    """Mean L2 between an image and the target."""
    return torch.mean((img - target) ** 2)


def clip_params(params: Dict) -> None:
    with torch.no_grad():
        for k in _UNIT_FIELDS:
            if f"materials.{k}" in params:
                params[f"materials.{k}"].clamp_(0.0, 1.0)


def step_samples(it: int, spp_per_step: int, n_stream: int):
    """The sample indices of step ``it``: consecutive, wrapping at the
    sampler's stream length."""
    return [(it * spp_per_step + i) % max(n_stream, 1) for i in range(spp_per_step)]
