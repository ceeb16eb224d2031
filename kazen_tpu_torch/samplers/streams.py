"""Per-lane deterministic sample streams for the wavefront integrator.

Every lane carries a small ``StreamState`` (pcg32 state + the current
dimension index) and draws are functions of it. Streams are keyed by
(pixel, sampleIndex, dimension, seed) as in the reference renderer
(sampler.cpp: generateSample = seed(Hash(p, seed)) + advance(idx*65536+dim)),
so the draws equal ``kazen_tpu.samplers.streams`` bit for bit.

Kinds: independent (sampler.cpp:18-71), stratified (:81-156), correlated
(:176-269) and pmj02bn (:273-390, with the tables of samplers/tables.py;
its spec comes from ``tables.make_pmj02bn_spec``, which puts them on the
device).

Each of the four draws (``init_stream_jump``, ``next_1d``, ``next_2d``,
``next_pixel_2d``) routes by what its lanes show: CUDA tensors launch the
kernel of ``draw_kernel.py`` (one launch a draw, no host read), CPU tensors
take the plain version beside it (``_init_plain``, ``_next_1d_plain``,
``_next_2d_plain``, ``_pixel_2d_plain``), which the kernel equals bit for
bit on the card. The tracer counts each draw by route (``sampler_route``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from ..core import rng
from ..utils import metrics
from . import draw_kernel

KINDS = ("independent", "stratified", "correlated", "pmj02bn")
ONE_MINUS_EPSILON = float.fromhex("0x1.fffffep-1")
N_PMJ_SETS = 5


@dataclass(frozen=True)
class SamplerSpec:
    """Static sampler configuration."""

    kind: str = "independent"
    sample_count: int = 1
    seed: int = 1
    # pmj02bn's tables on the device (samplers/tables.py:make_pmj02bn_spec);
    # equality and hashing ignore them, as the reference's spec does
    pmj_tables: Optional[torch.Tensor] = field(default=None, compare=False)  # (5, 65536, 2)
    bluenoise: Optional[torch.Tensor] = field(default=None, compare=False)  # (48, 128, 128)
    pmj_pixel_table: Optional[tuple] = field(default=None, compare=False)  # (table, tile)

    def __post_init__(self):
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
        if self.kind == "pmj02bn":
            return min(self.sample_count, 65536)
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


def _kernel_route(lanes: torch.Tensor) -> bool:
    """Whether a draw takes the kernel: for CUDA lanes, and only for them.
    The tracer counts the draw by its route."""
    route = "kernel" if lanes.device.type == "cuda" else "plain"
    metrics.sampler_route(route)
    return route == "kernel"


@metrics.traced("sampler.draw")
def init_stream_jump(spec: SamplerSpec, px, py, sample_index, jump) -> StreamState:
    """init_stream with the jump constants (A, S) of
    ``rng.advance_constants(sample_index * 65536)`` computed by the caller.
    ``sample_index`` and the jump are one for all lanes (an int and two
    ints), or one per lane (int64 lane tensors; dist/sharding.py's sample-
    batched lanes). pmj02bn never draws from pcg32 (sampler.cpp:352-357), so
    its state is not advanced, and its dimensions start at 2."""
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    if isinstance(sample_index, torch.Tensor):
        sample_index = sample_index.to(torch.int64)
    if _kernel_route(px):
        state, inc, dim, sample_index = draw_kernel.init(spec, px, py, sample_index, jump)
        return StreamState(state, inc, dim, px, py, sample_index)
    return _init_plain(spec, px, py, sample_index, jump)


def _init_plain(spec: SamplerSpec, px, py, sample_index, jump) -> StreamState:
    state, inc = rng.pcg_seed(rng.hash_pixel_seed(px, py, spec.seed))
    if spec.kind != "pmj02bn":
        state, inc = rng.pcg_advance_jump((state, inc), *jump)
    return StreamState(
        state=state,
        inc=inc,
        dim=torch.full_like(px, 2 if spec.kind == "pmj02bn" else 0),
        px=px,
        py=py,
        sample_index=(
            sample_index if isinstance(sample_index, torch.Tensor)
            else torch.full_like(px, int(sample_index))
        ),
    )


def _next_float(st: StreamState):
    (state, inc), u = rng.pcg_next_float((st.state, st.inc))
    return st._replace(state=state, inc=inc), u


def _hash32_dim(spec: SamplerSpec, st: StreamState):
    """Low 32 bits of Hash(pixel, dimension, seed)."""
    return rng.hash_pixel_dim_seed(st.px, st.py, st.dim, spec.seed) & rng.M32


@metrics.traced("sampler.draw")
def next_1d(spec: SamplerSpec, st: StreamState):
    """One uniform a lane: (stream, (N,) float32)."""
    if _kernel_route(st.px):
        state, dim, u = draw_kernel.draw(spec, st, 1)
        return st._replace(state=state, dim=dim), u
    return _next_1d_plain(spec, st)


def _next_1d_plain(spec: SamplerSpec, st: StreamState):
    n = spec.effective_sample_count
    if spec.kind == "independent":
        return _next_float(st)
    h32 = _hash32_dim(spec, st)
    if spec.kind == "pmj02bn":
        index = rng.permute(st.sample_index, n, h32)
        delta = _bluenoise_lookup(spec, st.dim, st.px, st.py)
        u = torch.clamp((index.to(torch.float32) + delta) / n, max=ONE_MINUS_EPSILON)
        return st._replace(dim=st.dim + 1), u
    if spec.kind == "stratified":
        stratum = rng.permute(st.sample_index, n, h32)
    else:  # correlated
        stratum = rng.permute(st.sample_index, n, (h32 * 0x45FBE943) & rng.M32)
    st, delta = _next_float(st)
    u = (stratum.to(torch.float32) + delta) / n
    return st._replace(dim=st.dim + 1), u


@metrics.traced("sampler.draw")
def next_2d(spec: SamplerSpec, st: StreamState):
    """Two uniforms a lane: (stream, (N, 2) float32)."""
    if _kernel_route(st.px):
        state, dim, u = draw_kernel.draw(spec, st, 2)
        return st._replace(state=state, dim=dim), u
    return _next_2d_plain(spec, st)


def _next_2d_plain(spec: SamplerSpec, st: StreamState):
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
    if spec.kind == "pmj02bn":
        pmj_instance = st.dim // 2
        permuted = rng.permute(st.sample_index, n, h32)
        index = torch.where(pmj_instance >= N_PMJ_SETS, permuted, st.sample_index)
        u = spec.pmj_tables[pmj_instance % N_PMJ_SETS, index]
        bn0 = _bluenoise_lookup(spec, st.dim, st.px, st.py)
        bn1 = _bluenoise_lookup(spec, st.dim + 1, st.px, st.py)
        u = u + torch.stack([bn0, bn1], dim=-1)
        u = torch.where(u >= 1.0, u - 1.0, u)
        return st._replace(dim=st.dim + 2), torch.clamp(u, max=ONE_MINUS_EPSILON)
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


@metrics.traced("sampler.draw")
def next_pixel_2d(spec: SamplerSpec, st: StreamState):
    """nextPixel2D: the sub-pixel jitter draw. pmj02bn reads its pixel-tile
    table and consumes no dimension (sampler.cpp:373-377); every other kind
    aliases next2D."""
    if spec.kind != "pmj02bn":
        return next_2d(spec, st)
    if _kernel_route(st.px):
        return st, draw_kernel.pixel_2d(spec, st)
    return _pixel_2d_plain(spec, st)


def _pixel_2d_plain(spec: SamplerSpec, st: StreamState):
    tile, tile_size = spec.pmj_pixel_table
    n = spec.effective_sample_count
    offset = ((st.px % tile_size) + (st.py % tile_size) * tile_size) * n + st.sample_index
    return st, tile[offset]


def _bluenoise_lookup(spec: SamplerSpec, table_index, px, py):
    """getBlueNoise (bluenoise.h:17-23): table[idx % 48][x % 128][y % 128]
    of the ranks divided by 65535 (in float32, by make_pmj02bn_spec)."""
    return spec.bluenoise[table_index % 48, px % 128, py % 128]
