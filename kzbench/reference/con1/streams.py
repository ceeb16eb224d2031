"""The sample streams of configuration 3: ``kz/samplers/streams.py`` and
the independent kind (sampler.cpp:18-71), whose every draw is the next
pcg32 float of the lane's stream and leaves its dimension where it was.
The independent branches are frozen copies of those of the port's
``samplers/streams.py`` plain draws; the other kinds are ``kz/``'s."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kz.samplers import streams as kz
from ..kz.samplers.streams import StreamState, _next_float, init_stream_jump  # noqa: F401

KINDS = kz.KINDS + ("independent",)


@dataclass(frozen=True)
class SamplerSpec(kz.SamplerSpec):
    """``kz/``'s spec, which may also name the independent kind."""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown sampler kind {self.kind}")


def next_1d(spec, st: StreamState):
    if spec.kind == "independent":
        return _next_float(st)
    return kz.next_1d(spec, st)


def next_2d(spec, st: StreamState):
    if spec.kind == "independent":
        st, u0 = _next_float(st)
        st, u1 = _next_float(st)
        return st, torch.stack([u0, u1], dim=-1)
    return kz.next_2d(spec, st)


def next_pixel_2d(spec, st: StreamState):
    """nextPixel2D: pmj02bn's pixel-tile table, next2D for every other
    kind."""
    if spec.kind == "pmj02bn":
        return kz.next_pixel_2d(spec, st)
    return next_2d(spec, st)
