"""The reference image of the Textured configuration at a sample of pixels:
the same computation as ``render.py``'s (the lanes of each target's filter
footprint run every pass of the call in one lane batch, in blocks; the
film's filter weights written out per target), on ``textured/``'s scene
compiler, path tracer and gaussian filter, with ``kz/``'s pmj02bn sampler
and camera. Plain PyTorch that imports nothing of the program; every ray
is traced by brute force (``trace.py``).

``precision="bfloat16"`` is the control, as in ``render.py``.
"""
from __future__ import annotations

import math

import torch

from .kz.core import rng
from .kz.integrate import camera as camera_mod
from .kz.samplers import streams
from .render import precision_of, sampler_spec
from .textured import description as D
from .textured import film as film_mod
from .textured import path_mis
from .textured.compiler import compile_scene


def compile_reference(build, config: dict, device):
    """The reference's own compiled scene of ``config`` (``build`` is the
    configuration's scene builder, given ``textured``'s description
    module)."""
    return compile_scene(build(D, config), device=device)


def _footprint(static):
    """Integer offsets of the lanes whose samples can reach a pixel."""
    r = film_mod.filter_radius(static)
    k = int(math.floor(r + 0.5))
    return [(ox, oy) for oy in range(-k, k + 1) for ox in range(-k, k + 1)]


def pixel_values(scene, static, targets: torch.Tensor, passes: int,
                 precision: str = "float32", lane_batch: int = 1 << 16) -> torch.Tensor:
    """The (K, 3) image values at ``targets`` ((K, 2) int64 x, y) after
    ``passes`` sample passes (sample indices 0 .. passes - 1)."""
    dev = scene.device
    spec = sampler_spec(static, dev)
    offs = torch.tensor(_footprint(static), dtype=torch.int64, device=dev)  # (M, 2)
    k, m = targets.shape[0], offs.shape[0]
    lane_px = (targets[:, None, :] + offs[None]).reshape(-1, 2)  # (K*M, 2)
    inside = ((lane_px[:, 0] >= 0) & (lane_px[:, 0] < static.width)
              & (lane_px[:, 1] >= 0) & (lane_px[:, 1] < static.height))
    lane_px = torch.where(inside[:, None], lane_px, 0)
    # every (lane, pass) pair; the pass index runs slowest
    n_lanes = lane_px.shape[0]
    sample = torch.arange(passes, device=dev).repeat_interleave(n_lanes)
    jumps = [rng.advance_constants(s * 65536) for s in range(passes)]
    ja = torch.tensor([rng.s64(a) for a, _ in jumps], dtype=torch.int64, device=dev)
    js = torch.tensor([rng.s64(b) for _, b in jumps], dtype=torch.int64, device=dev)
    px = lane_px[:, 0].repeat(passes)
    py = lane_px[:, 1].repeat(passes)
    li = torch.empty((px.shape[0], 3), device=dev)
    jit = torch.empty((px.shape[0], 2), device=dev)
    with precision_of(precision):
        for s in range(0, px.shape[0], lane_batch):
            e = min(px.shape[0], s + lane_batch)
            idx = sample[s:e]
            stream = streams.init_stream_jump(spec, px[s:e], py[s:e], idx, (ja[idx], js[idx]))
            stream, jitter = streams.next_pixel_2d(spec, stream)
            pixel_sample = torch.stack([px[s:e], py[s:e]], -1).to(torch.float32) + jitter
            stream, aperture = streams.next_2d(spec, stream)
            rays = camera_mod.sample_ray(scene, static, pixel_sample, aperture)
            _, li[s:e], _ = path_mis.li_wavefront(scene, static, spec, stream, rays)
            jit[s:e] = jitter
    # the film: filter weight of each (lane, pass) sample at its target, as
    # the program's grid splat evaluates it (offset - (jitter - 0.5))
    li = li.reshape(passes, k, m, 3)
    jit = jit.reshape(passes, k, m, 2)
    ok = (torch.isfinite(li) & (li >= 0.0)).all(-1, keepdim=True)
    li = torch.where(ok, li, 0.0)
    d = (-offs).to(torch.float32)  # target minus lane pixel
    wx = film_mod.filter_eval(static, d[None, None, :, 0] - (jit[..., 0] - 0.5))
    wy = film_mod.filter_eval(static, d[None, None, :, 1] - (jit[..., 1] - 0.5))
    w = wx * wy * inside.reshape(1, k, m).to(torch.float32)
    rgb = (li * w[..., None]).sum(dim=(0, 2))
    wsum = w.sum(dim=(0, 2))
    return torch.where(wsum[:, None] > 0.0, rgb / torch.clamp(wsum, min=1e-9)[:, None], 0.0)
