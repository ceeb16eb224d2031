"""Pass-based render checkpointing (SURVEY §5 'Checkpoint / resume').

The port of ``kazen_tpu/film/checkpoint.py``. The film accumulation buffer
plus the next sample index is the whole render state, because the sampler
streams are counter-based: resuming at sample s draws exactly what a
straight render draws there. Stored as a plain ``.npz`` with the
reference's keys (``film`` (H, W, 4) float32, ``next_sample``, ``seed``),
so a checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch


def save(path: str, film, next_sample: int, seed: int) -> None:
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        film=torch.as_tensor(film).detach().cpu().numpy(),
        next_sample=np.int64(next_sample),
        seed=np.int64(seed),
    )
    # numpy appends .npz to names without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load(path: str) -> Optional[Tuple[np.ndarray, int, int]]:
    """(film, next_sample, seed), or None when there is no checkpoint."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["film"], int(z["next_sample"]), int(z["seed"])


def render_resumable(
    scene,
    static,
    spec=None,
    spp: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 32,
) -> torch.Tensor:
    """render() with a film checkpoint every ``checkpoint_every`` passes and
    after the last; resumes from a checkpoint of the same seed that has not
    gone past ``spp``. Returns the (H, W, 3) image on the scene's device."""
    from ..core import rng
    from ..integrate.render import _render_pass, pixel_grid, sampler_spec
    from . import film as film_mod

    dev = scene.device
    if spec is None:
        spec = sampler_spec(static, dev)
    n_samples = spp if spp is not None else spec.effective_sample_count

    start = 0
    film = film_mod.make_film(static, dev)
    if checkpoint_path:
        ck = load(checkpoint_path)
        if ck is not None and ck[2] == static.seed and ck[1] <= n_samples:
            film = torch.as_tensor(ck[0], dtype=torch.float32, device=dev).clone()
            start = ck[1]

    px, py = pixel_grid(static, dev)
    for s in range(start, n_samples):
        film, _ = _render_pass(scene, static, spec, film, px, py, s, rng.advance_constants(s * 65536))
        done = s + 1
        if checkpoint_path and (done % checkpoint_every == 0 or done == n_samples):
            save(checkpoint_path, film, done, static.seed)
    return film_mod.to_bitmap(film)
