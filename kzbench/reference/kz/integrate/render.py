"""A full-frame render pass: the frozen subset of the program's
``integrate/render.py`` that the reference's gradient step needs (the
pixel grid, one sample pass through the path tracer into the grid splat)."""
from __future__ import annotations

import torch

from ..film import film as film_mod
from ..samplers import streams
from . import camera as camera_mod
from .path_mis import li_wavefront


def pixel_grid(static, device):
    """(px, py) int64 lanes of the full pixel grid in row-major order."""
    ys, xs = torch.meshgrid(
        torch.arange(static.height, device=device),
        torch.arange(static.width, device=device),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def render_pass(scene, static, spec, film, px, py, sample_index: int, jump):
    """One sample per lane over the full pixel grid, splatted into ``film``
    (in place); returns the film."""
    stream = streams.init_stream_jump(spec, px, py, sample_index, jump)
    stream, jitter = streams.next_pixel_2d(spec, stream)
    pixel_sample = torch.stack([px, py], -1).to(torch.float32) + jitter
    stream, aperture = streams.next_2d(spec, stream)
    rays = camera_mod.sample_ray(scene, static, pixel_sample, aperture)
    _, li, _ = li_wavefront(scene, static, spec, stream, rays)
    return film_mod.splat_grid(static, film, jitter, li)
