"""Top-level render driver (renderer.cpp:72-153): one lane per pixel, a host
loop over sample passes, the film accumulated in place.

The port of ``kazen_tpu/integrate/render.py`` for the path_mis integrator on
the full pixel grid (the lane-chunked pass is not ported yet). A scene the
compiler marked ``use_megakernel`` takes the megakernel
(integrate/megakernel.py), every other scene the ordered wavefront
(integrate/path_mis.py), as ``li_fn_for`` picks. Each sample index gets its
pcg32 jump from ``advance_constants(s * 65536)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import rng
from ..core.device import resolve_device
from ..film import film as film_mod
from ..samplers import streams
from ..samplers.streams import SamplerSpec
from . import camera as camera_mod
from .megakernel import li_megakernel
from .path_mis import li_wavefront


def li_fn_for(static):
    """The path_mis Li of the scene: the megakernel where the compiler
    enabled it, else the wavefront."""
    return li_megakernel if static.use_megakernel else li_wavefront


def sampler_spec(static) -> SamplerSpec:
    return SamplerSpec(
        kind=static.sampler_kind, sample_count=static.sample_count, seed=static.seed
    )


def pixel_grid(static, device):
    """(px, py) int64 lanes of the full pixel grid in row-major order."""
    ys, xs = torch.meshgrid(
        torch.arange(static.height, device=device),
        torch.arange(static.width, device=device),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def _render_pass(scene, static, spec, film, px, py, sample_index: int, jump):
    """One sample-per-pixel pass over the full pixel grid: returns the film
    (accumulated in place) and the number of rays traced (a tensor)."""
    stream = streams.init_stream_jump(spec, px, py, sample_index, jump)
    # renderSample (renderer.cpp:20-40): pixel jitter, then the aperture draw
    stream, jitter = streams.next_pixel_2d(spec, stream)
    pixel_sample = torch.stack([px, py], -1).to(torch.float32) + jitter
    stream, aperture = streams.next_2d(spec, stream)
    rays = camera_mod.sample_ray(scene, static, pixel_sample, aperture)
    _, li, nrays = li_fn_for(static)(scene, static, spec, stream, rays)
    return film_mod.splat_grid(static, film, jitter, li), nrays


def render(
    scene, static, spec: Optional[SamplerSpec] = None, spp: Optional[int] = None,
    device="cuda",
) -> torch.Tensor:
    """Render the full frame: the (H, W, 3) linear image on ``device``,
    which must be the device the scene was compiled for (CUDA unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    if scene.device.type != device.type:
        raise ValueError(f"the scene lives on {scene.device}, not on {device}")
    if static.integrator_kind != "path_mis":
        raise NotImplementedError(
            f"integrator {static.integrator_kind!r} is not ported to kazen_tpu_torch yet"
        )
    if spec is None:
        spec = sampler_spec(static)
    n_samples = spp if spp is not None else spec.effective_sample_count
    px, py = pixel_grid(static, scene.device)
    film = film_mod.make_film(static, scene.device)
    for s in range(n_samples):
        film, _ = _render_pass(
            scene, static, spec, film, px, py, s, rng.advance_constants(s * 65536)
        )
    return film_mod.to_bitmap(film)
