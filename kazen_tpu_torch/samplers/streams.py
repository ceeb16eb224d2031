"""Per-lane deterministic sample streams for the wavefront integrator.

Every lane carries a small ``StreamState`` (pcg32 state + the current
dimension index) and draws are functions of it. Streams are keyed by
(pixel, sampleIndex, dimension, seed) as in the reference renderer
(sampler.cpp: generateSample = seed(Hash(p, seed)) + advance(idx*65536+dim)),
so the draws equal ``kazen_tpu.samplers.streams`` bit for bit.

Ported kinds: independent (sampler.cpp:18-71), stratified (:81-156) and
correlated (:176-269). pmj02bn raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ..core import rng

KINDS = ("independent", "stratified", "correlated")


@dataclass(frozen=True)
class SamplerSpec:
    """Static sampler configuration."""

    kind: str = "independent"
    sample_count: int = 1
    seed: int = 1

    def __post_init__(self):
        if self.kind == "pmj02bn":
            raise NotImplementedError(
                "the pmj02bn sampler is not ported to kazen_tpu_torch yet"
            )
        if self.kind not in KINDS:
            raise ValueError(f"unknown sampler kind {self.kind}")

    @property
    def resolution(self) -> Tuple[int, int]:
        if self.kind == "stratified":
            # round the sample count up to a square (sampler.cpp:86-93)
            r = 4
            while r * r < self.sample_count:
                r += 1
            return (r, r)
        if self.kind == "correlated":
            # res[1] = floor(sqrt(N)); res[0] = ceil(N / res[1]) (:181-184)
            ry = int(self.sample_count**0.5)
            rx = (self.sample_count + ry - 1) // ry
            return (rx, ry)
        return (0, 0)

    @property
    def effective_sample_count(self) -> int:
        if self.kind == "stratified":
            r = self.resolution[0]
            return r * r
        if self.kind == "correlated":
            rx, ry = self.resolution
            return rx * ry
        return self.sample_count


class StreamState(NamedTuple):
    """All fields are int64 lane tensors (see core/rng.py)."""

    state: torch.Tensor  # pcg32 state (64-bit pattern)
    inc: torch.Tensor  # pcg32 increment (64-bit pattern)
    dim: torch.Tensor  # current dimension index
    px: torch.Tensor
    py: torch.Tensor
    sample_index: torch.Tensor

    def index(self, idx) -> "StreamState":
        """The lanes ``idx`` (a permutation or mask) of every field."""
        return StreamState(*(f[idx] for f in self))


def init_stream(spec: SamplerSpec, px, py, sample_index: int) -> StreamState:
    """generateSample(pixel, sampleIndex, dim=0) for a lane batch."""
    return init_stream_jump(
        spec, px, py, sample_index, rng.advance_constants(sample_index * 65536)
    )


def init_stream_jump(spec: SamplerSpec, px, py, sample_index: int, jump) -> StreamState:
    """init_stream with the jump constants (A, S) of
    ``rng.advance_constants(sample_index * 65536)`` computed by the caller."""
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    st = rng.pcg_seed(rng.hash_pixel_seed(px, py, spec.seed))
    state, inc = rng.pcg_advance_jump(st, *jump)
    return StreamState(
        state=state,
        inc=inc,
        dim=torch.zeros_like(px),
        px=px,
        py=py,
        sample_index=torch.full_like(px, int(sample_index)),
    )


def _next_float(st: StreamState):
    (state, inc), u = rng.pcg_next_float((st.state, st.inc))
    return st._replace(state=state, inc=inc), u


def _hash32_dim(spec: SamplerSpec, st: StreamState):
    """Low 32 bits of Hash(pixel, dimension, seed)."""
    return rng.hash_pixel_dim_seed(st.px, st.py, st.dim, spec.seed) & rng.M32


def next_1d(spec: SamplerSpec, st: StreamState):
    n = spec.effective_sample_count
    if spec.kind == "independent":
        return _next_float(st)
    h32 = _hash32_dim(spec, st)
    if spec.kind == "stratified":
        stratum = rng.permute(st.sample_index, n, h32)
    else:  # correlated
        stratum = rng.permute(st.sample_index, n, (h32 * 0x45FBE943) & rng.M32)
    st, delta = _next_float(st)
    u = (stratum.to(torch.float32) + delta) / n
    return st._replace(dim=st.dim + 1), u


def next_2d(spec: SamplerSpec, st: StreamState):
    n = spec.effective_sample_count
    if spec.kind == "independent":
        st, u0 = _next_float(st)
        st, u1 = _next_float(st)
        return st, torch.stack([u0, u1], dim=-1)
    h32 = _hash32_dim(spec, st)
    if spec.kind == "stratified":
        res = spec.resolution[0]
        stratum = rng.permute(st.sample_index, n, h32)
        x = (stratum % res).to(torch.float32)
        y = (stratum // res).to(torch.float32)
        st, dx = _next_float(st)
        st, dy = _next_float(st)
        u = torch.stack([(x + dx) / res, (y + dy) / res], dim=-1)
        return st._replace(dim=st.dim + 2), u
    rx, ry = spec.resolution  # correlated
    s = rng.permute(st.sample_index, n, (h32 * 0x51633E2D) & rng.M32)
    y = s // rx
    x = s % rx
    sx = rng.permute(x, rx, (h32 * 0x68BC21EB) & rng.M32).to(torch.float32)
    sy = rng.permute(y, ry, (h32 * 0x02E5BE93) & rng.M32).to(torch.float32)
    st, jx = _next_float(st)
    st, jy = _next_float(st)
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    u = torch.stack(
        [(xf + (sy + jx) / ry) / rx, (yf + (sx + jy) / rx) / ry], dim=-1
    )
    return st._replace(dim=st.dim + 2), u


def next_pixel_2d(spec: SamplerSpec, st: StreamState):
    """nextPixel2D: the sub-pixel jitter draw (an alias of next2D for every
    ported kind)."""
    return next_2d(spec, st)
