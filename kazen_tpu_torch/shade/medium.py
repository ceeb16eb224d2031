"""Participating media: non-scattering Beer-Lambert absorption
(medium.cpp:5-31, medium.h:6-14).

The port of ``kazen_tpu/shade/medium.py``. The reference registers this one
medium, used only by its commented-out volumetric integrator
(integrator.cpp:358-551): the absorption coefficient comes from a target
color reached at a reference distance, sigma = -log(color) / distance, and
the transmittance over t is exp(-sigma * t).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.device import resolve_device


class NonScatterMedium(NamedTuple):
    sigma: torch.Tensor  # (3,) absorption coefficient


def make_nonscatter(color, distance: float = 1.0, device="cuda") -> NonScatterMedium:
    """NonScatterMedium's constructor (medium.cpp:7-15), on ``device`` (the
    card unless the caller asks for the CPU)."""
    c = torch.clamp(
        torch.as_tensor(color, dtype=torch.float32, device=resolve_device(device)), 1e-6, 1.0
    )
    return NonScatterMedium(sigma=-torch.log(c) / distance)


def transmission(medium: NonScatterMedium, t):
    """Beer-Lambert transmittance over path length t (medium.cpp:20-28)."""
    return torch.exp(-medium.sigma * torch.as_tensor(t)[..., None])


def distance_sample(medium: NonScatterMedium, u):
    """Distance sampling for the mean channel."""
    return -torch.log(torch.clamp(1.0 - u, min=1e-20)) / medium.sigma.mean()
