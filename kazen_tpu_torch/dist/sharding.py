"""Lane sharding over processes: the port of ``kazen_tpu/dist/sharding.py``
(the reference's replacement for the TBB tile pool, renderer.cpp:94-127,
SURVEY §2.8) on torch.distributed.

Model: the lanes of a pass (pixels, or pixels x sample batches) are split
into one contiguous slice per rank (dist/multihost.py:local_lane_slice);
the scene is built identically in every process; each rank splats its
lanes' samples into a film of its own with the scatter splat
(``film.splat``), and one ``all_reduce(SUM)`` of the film gives every rank
the whole frame. Counter-based sampler streams are keyed by pixel, so the
image does not depend on the placement of the lanes. Without a process
group every function runs as a world of one.

``inverse_train_step`` is the sharded gradient step: each rank takes the
gradient of the loss of the reduced film through its own partial film, and
the parameter gradients are summed over the ranks (the grad-of-psum
structure of the reference's step, sharding.py:229-270).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import rng
from ..diff.inverse import image_loss, material_float_params, wavefront_static
from ..film import film as film_mod
from ..integrate.render import _render_pass, pixel_grid, sampler_spec
from .multihost import local_lane_slice


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; ``t`` itself without a group."""
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def jump_table(sample_indices, device) -> torch.Tensor:
    """(S, 2) int64 pcg jump constants (A, S) of ``sample_indices``, the
    per-lane form of render()'s per-pass jump (one lane batch can then
    carry several sample indices)."""
    rows = [[rng.s64(v) for v in rng.advance_constants(int(s) * 65536)] for s in sample_indices]
    return torch.tensor(rows, dtype=torch.int64, device=device)


def make_sample_lanes(static, sample_batches: int, device):
    """(px, py, batch) int64 lanes of the pixels x sample-batches axis
    (SURVEY §2.8's sharding of the sample dimension at a fixed pixel count):
    the pixel grid in row-major order once per batch."""
    h, w = static.height, static.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = np.tile(xs.reshape(-1), sample_batches)
    py = np.tile(ys.reshape(-1), sample_batches)
    batch = np.repeat(np.arange(sample_batches), h * w)
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device) for a in (px, py, batch))


def _lane_slice(lanes, group):
    start, stop = local_lane_slice(lanes[0].shape[0], group)
    return [x[start:stop] for x in lanes]


def render_distributed(scene, static, spec=None, spp: Optional[int] = None, group=None):
    """The full frame with the pixel lanes split over the ranks of ``group``
    (the default group): the (H, W, 3) image, on every rank."""
    dev = scene.device
    if spec is None:
        spec = sampler_spec(static, dev)
    n_samples = spp if spp is not None else spec.effective_sample_count
    px, py = _lane_slice(pixel_grid(static, dev), group)
    film = film_mod.make_film(static, dev)
    for s in range(n_samples):
        _render_pass(scene, static, spec, film, px, py, s, rng.advance_constants(s * 65536),
                     grid_splat=False)
    return film_mod.to_bitmap(_all_reduce(film, group))


def render_sample_sharded(scene, static, spec=None, spp: Optional[int] = None,
                          sample_batches: int = 1, group=None):
    """The full frame with the pixels x sample-batches lanes split over the
    ranks: ``sample_batches`` sample indices per pass (each lane carries its
    own sample index and jump), a host loop over the rest. As in the
    reference, a last pass that runs past ``spp`` renders its extra batches
    with the last sample index's jump."""
    dev = scene.device
    if spec is None:
        spec = sampler_spec(static, dev)
    n_samples = spp if spp is not None else spec.effective_sample_count
    S = max(1, min(sample_batches, n_samples))
    px, py, batch = _lane_slice(make_sample_lanes(static, S, dev), group)
    film = film_mod.make_film(static, dev)
    for s0 in range(0, n_samples, S):
        jumps = jump_table([min(s0 + b, n_samples - 1) for b in range(S)], dev)[batch]
        _render_pass(scene, static, spec, film, px, py, s0 + batch, (jumps[:, 0], jumps[:, 1]),
                     grid_splat=False)
    return film_mod.to_bitmap(_all_reduce(film, group))


def inverse_train_step(scene, static, spec, group=None):
    """The sharded gradient step of the L2 image loss against a target, with
    respect to the material float table and the texel pool (the
    inverse-rendering parameter set). Returns ``step(scene_arrays, target,
    px, py, sample_index, jump) -> (loss, grads)``; px and py are the whole
    frame's lanes, of which each rank renders its slice. Every rank gets the
    same loss and the summed gradients.

    The film is reduced outside autograd, dL/dfilm is taken on the reduced
    film, and each rank back-propagates it through its own partial film:
    a differentiable all-reduce would scale the gradient by the world
    size."""
    static = wavefront_static(static)

    def step(scene_arrays, target, px, py, sample_index, jump):
        params = {
            k: v.detach().clone().requires_grad_(True)
            for k, v in material_float_params(scene_arrays.materials).items()
        }
        texels = scene_arrays.textures.texels.detach().clone().requires_grad_(True)
        sc = dataclasses.replace(
            scene_arrays,
            materials=dataclasses.replace(scene_arrays.materials, **params),
            textures=dataclasses.replace(scene_arrays.textures, texels=texels),
        )
        lpx, lpy = _lane_slice((px, py), group)
        local, _ = _render_pass(sc, static, spec, film_mod.make_film(static, sc.device), lpx, lpy,
                                sample_index, jump, grid_splat=False)
        full = _all_reduce(local.detach().clone(), group).requires_grad_(True)
        loss = image_loss(film_mod.to_bitmap(full), target)
        (dfilm,) = torch.autograd.grad(loss, full)
        names = list(params) + ["texels"]
        leaves = list(params.values()) + [texels]
        grads = torch.autograd.grad(local, leaves, dfilm, allow_unused=True)
        out = {}
        for name, leaf, g in zip(names, leaves, grads):
            out[name] = _all_reduce(torch.zeros_like(leaf) if g is None else g, group)
        return loss.detach(), out

    return step
