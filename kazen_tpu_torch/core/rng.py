"""Counter-based deterministic random streams, bit-exact with kazen_tpu.

Ports ``kazen_tpu/core/u64.py`` and ``kazen_tpu/core/rng.py``:

* MurmurHash64A / MixBits / Hash(...)   (hash.h:15-113)
* pcg32 seed/nextUInt/nextFloat         (pcg32.h:42-176)
* pcg32.advance(delta) as an affine jump ``state' = A*state + S*inc`` with
  host-side (A, S) from Brown's algorithm (``advance_constants``)
* Kensler's ``permute(i, l, p)``        (common.cpp:316-344)
* sampleTEA32                           (common.cpp:304-314)

PyTorch has no uint32/uint64 add, shift or compare on every device, so every
value lives in an ``int64`` tensor: a uint64 is held as the int64 with the
same bits, a uint32 as a value in [0, 2**32). Sums and products of int64
wrap modulo 2**64, which is exactly what pcg32 and Murmur need; right shifts
of int64 are arithmetic, so ``shr`` masks after each one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils import metrics

M32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
PCG32_MULT = 0x5851F42D4C957F2D
_MURMUR_M = 0xC6A4A7935BD1E995


def s64(v: int) -> int:
    """A Python int taken mod 2**64, as the int64 with the same bits."""
    v &= _MASK64
    return v - (1 << 64) if v >= (1 << 63) else v


def to_u64(x: torch.Tensor):
    """Host readback of a 64-bit lane tensor as a numpy uint64 array."""
    return x.detach().cpu().numpy().view("uint64")


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of the 64-bit pattern by a static amount."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


# ---------------------------------------------------------------------------
# MurmurHash64A (hash.h:15-65) for the two fixed key layouts the samplers use
# ---------------------------------------------------------------------------


def _murmur_round(h: torch.Tensor, k) -> torch.Tensor:
    m = s64(_MURMUR_M)
    k = k * m
    k = k ^ shr(k, 47)
    k = k * m
    h = h ^ k
    return h * m


def _murmur_finalize(h: torch.Tensor) -> torch.Tensor:
    m = s64(_MURMUR_M)
    h = h ^ shr(h, 47)
    h = h * m
    return h ^ shr(h, 47)


def hash_pixel_seed(px: torch.Tensor, py: torch.Tensor, seed: int) -> torch.Tensor:
    """Hash(Point2i p, uint64 seed): 16-byte key, blocks (py<<32|px), seed."""
    h = torch.full_like(px, s64(16 * _MURMUR_M))
    h = _murmur_round(h, (py << 32) | px)
    h = _murmur_round(h, torch.full_like(px, s64(seed)))
    return _murmur_finalize(h)


def hash_pixel_dim_seed(px, py, dim, seed: int) -> torch.Tensor:
    """Hash(Point2i p, uint32 dim, uint64 seed): 20-byte key, blocks
    (py<<32|px), (seed_lo<<32|dim); 4-byte tail = seed_hi. ``dim`` may be an
    int or a per-lane tensor."""
    seed &= _MASK64
    seed_lo = seed & M32
    seed_hi = seed >> 32
    h = torch.full_like(px, s64(20 * _MURMUR_M))
    h = _murmur_round(h, (py << 32) | px)
    if isinstance(dim, torch.Tensor):
        k2 = dim | s64(seed_lo << 32)
    else:
        k2 = torch.full_like(px, s64((seed_lo << 32) | (dim & M32)))
    h = _murmur_round(h, k2)
    h = h ^ s64(seed_hi)
    h = h * s64(_MURMUR_M)
    return _murmur_finalize(h)


def mix_bits(v: torch.Tensor) -> torch.Tensor:
    """MixBits (hash.h:72-79)."""
    v = v ^ shr(v, 31)
    v = v * s64(0x7FB5D329728EA185)
    v = v ^ shr(v, 27)
    v = v * s64(0x81DADEF4BC2DD44D)
    return v ^ shr(v, 33)


# ---------------------------------------------------------------------------
# pcg32 (pcg32.h)
# ---------------------------------------------------------------------------

PCGState = Tuple[torch.Tensor, torch.Tensor]  # (state, inc), 64-bit patterns


def pcg_seed_full(initstate: torch.Tensor, initseq: torch.Tensor) -> PCGState:
    """pcg32::seed(initstate, initseq) (pcg32.h:57-63), closed form."""
    inc = (initseq << 1) | 1
    state = (inc + initstate) * s64(PCG32_MULT) + inc
    return state, inc


def pcg_seed(h: torch.Tensor) -> PCGState:
    """pcg32::seed(initseq) = seed(MixBits(h), h) (pcg32.h:65-67)."""
    return pcg_seed_full(mix_bits(h), h)


def pcg_next_uint(st: PCGState) -> Tuple[PCGState, torch.Tensor]:
    """One LCG step + the PCG output permutation (pcg32.h:70-76)."""
    old, inc = st
    state = old * s64(PCG32_MULT) + inc
    xorshifted = shr(shr(old, 18) ^ old, 27) & M32
    rot = shr(old, 59)
    out = ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & M32
    return (state, inc), out


def uint_to_float(u: torch.Tensor) -> torch.Tensor:
    """[1,2) mantissa trick -> [0,1) float (pcg32.h:118-127)."""
    bits = ((u >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def pcg_next_float(st: PCGState) -> Tuple[PCGState, torch.Tensor]:
    st, u = pcg_next_uint(st)
    return st, uint_to_float(u)


def advance_constants(delta: int) -> Tuple[int, int]:
    """Host-side Brown jump-ahead (pcg32.h:137-160): (A_d, S_d) with
    ``state' = A_d*state + S_d*inc mod 2^64`` (S_d computed with inc := 1;
    valid because acc_plus is linear homogeneous in inc)."""
    delta &= _MASK64
    acc_mult, acc_plus = 1, 0
    cur_mult, cur_plus = PCG32_MULT, 1
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & _MASK64
            acc_plus = (acc_plus * cur_mult + cur_plus) & _MASK64
        cur_plus = ((cur_mult + 1) * cur_plus) & _MASK64
        cur_mult = (cur_mult * cur_mult) & _MASK64
        delta >>= 1
    return acc_mult, acc_plus


def pcg_advance_jump(st: PCGState, a, s) -> PCGState:
    """pcg32::advance with jump constants from ``advance_constants``: Python
    ints, or int64 lane tensors holding their bits (one jump per lane)."""
    state, inc = st
    if not isinstance(a, torch.Tensor):
        a, s = s64(a), s64(s)
    return state * a + inc * s, inc


def pcg_advance(st: PCGState, delta: int) -> PCGState:
    """pcg32::advance(delta)."""
    return pcg_advance_jump(st, *advance_constants(delta))


# ---------------------------------------------------------------------------
# Kensler permute (common.cpp:316-344); all values in [0, 2**32)
# ---------------------------------------------------------------------------


def _permute_hash_round(i, w, p):
    i = i ^ p
    i = (i * 0xE170893D) & M32
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = (i * 0x0929EB3F) & M32
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = (i * (1 | (p >> 27))) & M32
    i = (i * 0x6935FA69) & M32
    i = i ^ ((i & w) >> 11)
    i = (i * 0x74DCB303) & M32
    i = i ^ ((i & w) >> 2)
    i = (i * 0x9E501CC3) & M32
    i = i ^ ((i & w) >> 2)
    i = (i * 0xC860A3DF) & M32
    i = i & w
    i = i ^ (i >> 5)
    return i


def _all_accepted(ok: torch.Tensor) -> bool:
    """The host's read of whether every lane of ``permute`` is accepted."""
    with metrics.sync("core/rng.py:permute ok.all()"):
        return bool(ok.all())


def permute(i: torch.Tensor, l, p: torch.Tensor) -> torch.Tensor:
    """Cycle-walking hash permutation of [0, l); ``l`` an int or a tensor."""
    i, p = torch.broadcast_tensors(i, p)
    with metrics.sync("core/rng.py:permute as_tensor(l)", not isinstance(l, torch.Tensor)):
        l = torch.as_tensor(l, dtype=torch.int64, device=i.device)
    w = l - 1
    for s in (1, 2, 4, 8, 16):
        w = w | (w >> s)
    # do-while: one round for every lane, then walk rejected lanes on
    cur = _permute_hash_round(i, w, p)
    ok = cur < l
    while not _all_accepted(ok):
        nxt = _permute_hash_round(cur, w, p)
        cur = torch.where(ok, cur, nxt)
        ok = ok | (nxt < l)
    return ((cur + p) & M32) % l


def sample_tea32(v0: torch.Tensor, v1: torch.Tensor, rounds: int = 4):
    """TEA-32 hash (common.cpp:304-314); returns (hi, lo) = (v1, v0)."""
    total = 0
    for _ in range(rounds):
        total = (total + 0x9E3779B9) & M32
        v0 = (
            v0
            + ((((v1 << 4) + 0xA341316C) & M32)
               ^ ((v1 + total) & M32)
               ^ (((v1 >> 5) + 0xC8013EA4) & M32))
        ) & M32
        v1 = (
            v1
            + ((((v0 << 4) + 0xAD90777D) & M32)
               ^ ((v0 + total) & M32)
               ^ (((v0 >> 5) + 0x7E95761E) & M32))
        ) & M32
    return v1, v0
