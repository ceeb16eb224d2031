"""Top-level render driver (renderer.cpp:72-153): one lane per pixel, a host
loop over sample passes, the film accumulated in place.

The port of ``kazen_tpu/integrate/render.py``. ``li_fn_for`` picks the Li of
the scene's integrator: for path_mis, the megakernel (integrate/
megakernel.py) where the compiler set ``use_megakernel``, else the ordered
wavefront (integrate/path_mis.py); for the debug integrators, their
wavefronts (integrate/simple.py). Each sample index gets its pcg32 jump
from ``advance_constants(s * 65536)``. A pass runs on the full pixel grid,
or with ``lane_chunk`` in chunks of that many lanes, whose films are added
with the scatter splat.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import rng
from ..core.device import resolve_device
from ..film import film as film_mod
from ..samplers import streams
from ..samplers.streams import SamplerSpec
from ..utils import metrics as metrics_mod
from . import camera as camera_mod
from .megakernel import li_megakernel
from .path_mis import li_wavefront
from .simple import LI_FNS

_OFF_IMAGE = 0x7FFFFF  # x of the padding lanes of a chunked pass


def li_fn_for(static):
    """The scene's Li: ``(scene, static, spec, stream, rays) -> (stream, li,
    rays traced)``."""
    if static.integrator_kind == "path_mis":
        return li_megakernel if static.use_megakernel else li_wavefront
    return LI_FNS[static.integrator_kind]


def sampler_spec(static, device="cuda") -> SamplerSpec:
    """The scene's sampler; pmj02bn's tables go to ``device``."""
    if static.sampler_kind == "pmj02bn":
        from ..samplers.tables import make_pmj02bn_spec

        return make_pmj02bn_spec(static.sample_count, static.seed, resolve_device(device))
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


def lane_chunks(static, device, lane_chunk: Optional[int]):
    """The pass's (px, py) lane batches: the full grid, or chunks of
    ``lane_chunk`` lanes whose last is padded with off-image lanes (x =
    0x7FFFFF), which render pixel (0x7FFFFF, 0)'s streams and splat with
    weight 0."""
    px, py = pixel_grid(static, device)
    n = px.shape[0]
    if lane_chunk is None or n <= lane_chunk:
        return [(px, py)]
    pad = (-n) % lane_chunk
    px = torch.cat([px, torch.full((pad,), _OFF_IMAGE, dtype=px.dtype, device=device)])
    py = torch.cat([py, torch.zeros(pad, dtype=py.dtype, device=device)])
    return [
        (px[i:i + lane_chunk], py[i:i + lane_chunk]) for i in range(0, n + pad, lane_chunk)
    ]


def _render_pass(scene, static, spec, film, px, py, sample_index: int, jump,
                 grid_splat: bool = True):
    """One sample per lane over a lane batch: returns the film (accumulated
    in place) and the number of rays traced (a tensor). With ``grid_splat``
    the lanes must be the full pixel grid in row-major order."""
    with metrics_mod.span("render.pass", "index", sample_index, film.device):
        stream = streams.init_stream_jump(spec, px, py, sample_index, jump)
        # renderSample (renderer.cpp:20-40): pixel jitter, then the aperture draw
        stream, jitter = streams.next_pixel_2d(spec, stream)
        pixel_sample = torch.stack([px, py], -1).to(torch.float32) + jitter
        stream, aperture = streams.next_2d(spec, stream)
        rays = camera_mod.sample_ray(scene, static, pixel_sample, aperture)
        _, li, nrays = li_fn_for(static)(scene, static, spec, stream, rays)
        metrics_mod.rays(nrays)
        if grid_splat:
            return film_mod.splat_grid(static, film, jitter, li), nrays
        return film_mod.splat(static, film, pixel_sample, li), nrays


def render(
    scene, static, spec: Optional[SamplerSpec] = None, spp: Optional[int] = None,
    lane_chunk: Optional[int] = None, verbose: bool = False, metrics=None,
    device="cuda",
) -> torch.Tensor:
    """Render the full frame: the (H, W, 3) linear image on ``device``,
    which must be the device the scene was compiled for (CUDA unless the
    caller asks for the CPU). ``lane_chunk`` bounds the lanes of one pass
    (the film then takes the scatter splat); ``verbose`` prints an ETA
    progress line; a utils.metrics.RenderMetrics passed as ``metrics``
    collects each pass's seconds and rays, read once when the call ends."""
    device = resolve_device(device)
    if scene.device.type != device.type:
        raise ValueError(f"the scene lives on {scene.device}, not on {device}")
    with metrics_mod.span("render.call"):
        if spec is None:
            with metrics_mod.span("sampler.tables"):
                spec = sampler_spec(static, scene.device)
        n_samples = spp if spp is not None else spec.effective_sample_count
        chunks = lane_chunks(static, scene.device, lane_chunk)
        progress = None
        if verbose:
            progress = metrics_mod.Progress(n_samples)
        film = film_mod.make_film(static, scene.device)
        lanes = static.width * static.height
        for s in range(n_samples):
            jump = rng.advance_constants(s * 65536)
            timing = (metrics_mod.NULL if metrics is None
                      else metrics.pass_span(s, lanes, film.device))
            with timing as counts:
                for px, py in chunks:
                    film, nrays = _render_pass(
                        scene, static, spec, film, px, py, s, jump, grid_splat=len(chunks) == 1
                    )
                    if counts is not None:
                        counts.append(nrays)
            if progress is not None:
                progress.update(s + 1)
        if metrics is not None:
            metrics.finish()
        return film_mod.to_bitmap(film)
