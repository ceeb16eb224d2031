"""Inverse rendering: gradient-based recovery of scene parameters from a
target image (BASELINE config 5, "differentiable end to end").

The port of ``kazen_tpu/diff/inverse.py``. The whole forward path (sampling,
BSDFs, MIS weights, film splat) is differentiable under torch.autograd;
discrete choices (lobe selection, RR, light pick) depend on the uniforms
only, and the trace kernels run on gradient-stopped rays whose (t, u, v)
``prepare_from_rows`` recomputes in closed form, as in the reference: K1/K2
need no backward. Each step renders ``spp_per_step`` sample passes at fresh
sample indices, so the stochastic gradient sweeps the sampler stream over
time.

Parameters: any subset of the material float table, the texel pool, the
light radiance and the background colour. Adam with optax's defaults (b1
0.9, b2 0.999, eps 1e-8).

The megakernel packs its tables once at compile time, so a parameter
swapped in afterwards would not reach it: ``optimize`` always runs the
wavefront, as the reference's CPU runs do.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from ..core import rng
from ..film import film as film_mod
from ..integrate.render import _render_pass, pixel_grid, sampler_spec
from ..utils import metrics

PARAM_KEYS = ("materials", "texels", "light_radiance", "bg_color")

# The differentiable subset of the material table (kazen_tpu/dist/
# sharding.py:MATERIAL_FLOAT_FIELDS)
MATERIAL_FLOAT_FIELDS = (
    "base_color",
    "metallic",
    "roughness",
    "anisotropy",
    "specular",
    "specular_tint",
    "clearcoat",
    "clearcoat_roughness",
    "sheen",
    "sheen_tint",
    "int_ior",
    "ext_ior",
    "alpha",
    "eta_c",
    "k_c",
)

_UNIT_FIELDS = ("base_color", "metallic", "roughness")  # clipped to [0, 1]


def material_float_params(materials) -> Dict[str, torch.Tensor]:
    """The differentiable subset of the material table."""
    return {k: getattr(materials, k) for k in MATERIAL_FLOAT_FIELDS}


def get_params(arrays, keys: Sequence[str]) -> Dict:
    """The scene's tensors of the parameter groups ``keys`` (PARAM_KEYS)."""
    out = {}
    if "materials" in keys:
        out["materials"] = material_float_params(arrays.materials)
    if "texels" in keys:
        out["texels"] = arrays.textures.texels
    if "light_radiance" in keys:
        out["light_radiance"] = arrays.light_radiance
    if "bg_color" in keys:
        out["bg_color"] = arrays.bg_color
    return out


def apply_params(arrays, params: Dict):
    """``arrays`` with the parameter groups of ``params`` swapped in."""
    if "materials" in params:
        arrays = dataclasses.replace(
            arrays, materials=dataclasses.replace(arrays.materials, **params["materials"])
        )
    if "texels" in params:
        arrays = dataclasses.replace(
            arrays, textures=dataclasses.replace(arrays.textures, texels=params["texels"])
        )
    if "light_radiance" in params:
        arrays = dataclasses.replace(arrays, light_radiance=params["light_radiance"])
    if "bg_color" in params:
        arrays = dataclasses.replace(arrays, bg_color=params["bg_color"])
    return arrays


def leaves(params: Dict):
    """The tensors of a parameter dict, in a fixed order."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.extend(v[f] for f in sorted(v))
        else:
            out.append(v)
    return out


def as_leaves(params: Dict) -> Dict:
    """A copy of ``params`` whose tensors are new leaves that require grad."""
    return {
        k: ({f: t.detach().clone().requires_grad_(True) for f, t in v.items()}
            if isinstance(v, dict) else v.detach().clone().requires_grad_(True))
        for k, v in params.items()
    }


def wavefront_static(static):
    """``static`` routed to the wavefront: the megakernel reads tables packed
    at compile time, which carry no parameter swapped in since."""
    if static.use_megakernel:
        return dataclasses.replace(static, use_megakernel=False, mega_cfg=None)
    return static


def step_samples(it: int, spp_per_step: int, n_stream: int):
    """The sample indices of step ``it`` (kazen_tpu/diff/inverse.py:131-139):
    consecutive, wrapping at the sampler's stream length."""
    return [(it * spp_per_step + i) % max(n_stream, 1) for i in range(spp_per_step)]


def render_image(arrays, static, spec, params: Dict, sample_indices) -> torch.Tensor:
    """The image of ``sample_indices``' passes with ``params`` swapped into
    ``arrays``: differentiable with respect to ``params``."""
    static = wavefront_static(static)
    sc = apply_params(arrays, params)
    px, py = pixel_grid(static, arrays.device)
    film = film_mod.make_film(static, arrays.device)
    for s in sample_indices:
        film, _ = _render_pass(sc, static, spec, film, px, py, s, rng.advance_constants(s * 65536))
    return film_mod.to_bitmap(film)


def image_loss(img, target) -> torch.Tensor:
    """Mean L2 between an image and the target."""
    return torch.mean((img - target) ** 2)


def clip_params(params: Dict) -> None:
    """Clip base_color, metallic, roughness and the texels to [0, 1], in
    place and outside autograd."""
    with torch.no_grad():
        for k in _UNIT_FIELDS:
            if k in params.get("materials", {}):
                params["materials"][k].clamp_(0.0, 1.0)
        if "texels" in params:
            params["texels"].clamp_(0.0, 1.0)


@dataclass
class OptimizeResult:
    params: Dict
    losses: np.ndarray
    arrays: object  # SceneArrays with the optimized parameters applied


def optimize(
    arrays,
    static,
    target,
    param_keys: Sequence[str] = ("materials",),
    steps: int = 100,
    learning_rate: float = 5e-2,
    spp_per_step: int = 1,
    spec=None,
    clip_to_unit: bool = True,
    callback=None,
) -> OptimizeResult:
    """Minimize the mean L2 between the rendered image and ``target`` over
    the parameter groups ``param_keys``, on the scene's device."""
    static = wavefront_static(static)
    if spec is None:
        spec = sampler_spec(static, arrays.device)
    with metrics.sync("diff/inverse.py:optimize as_tensor(target)",
                      not isinstance(target, torch.Tensor) or target.device != arrays.device):
        target = torch.as_tensor(target, dtype=torch.float32, device=arrays.device)
    params = as_leaves(get_params(arrays, param_keys))
    opt = torch.optim.Adam(leaves(params), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    n_stream = spec.effective_sample_count
    for it in range(steps):
        with metrics.span("optimize.step", "step", it):
            with metrics.span("forward"):
                opt.zero_grad(set_to_none=True)
                img = render_image(arrays, static, spec, params,
                                   step_samples(it, spp_per_step, n_stream))
                loss = image_loss(img, target)
            with metrics.span("backward"):
                loss.backward()
            with metrics.span("optimizer"):
                opt.step()
                if clip_to_unit:
                    clip_params(params)
            with metrics.sync("diff/inverse.py:optimize float(loss)"):
                losses.append(float(loss.detach()))
            if callback is not None:
                callback(it, losses[-1], params)
    final = {
        k: ({f: t.detach() for f, t in v.items()} if isinstance(v, dict) else v.detach())
        for k, v in params.items()
    }
    return OptimizeResult(params=final, losses=np.asarray(losses), arrays=apply_params(arrays, final))
