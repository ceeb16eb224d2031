"""Sample tables for the pmj02bn sampler.

The port of ``kazen_tpu/samplers/tables.py``; ``_tables.npz`` beside this
file is a byte copy of that package's table file, so the port needs no
regeneration (the blue-noise ranks take minutes of numpy). The reference
renderer's table data files (src/kazen/pmj02table.cpp,
src/kazen/bluenoise.cpp, multi-MB pbrt-v4 data) were never committed
(SURVEY §2.4: the repo as checked in does not build), so this module
*regenerates* equivalent tables:

* pmj02 point sets: Owen-scrambled Sobol (0,2)-sequences. Owen scrambling
  preserves the (0,2)-net/sequence elementary-interval properties that the
  pmj02 construction guarantees, including the "exactly n/4^k points per
  2^-k square cell" stratification that the pixel-tile bucketing
  (sampler.cpp:289-315) relies on.
* blue-noise textures: void-and-cluster (Ulichney) rank matrices at 128^2,
  48 tables, toroidal gaussian energy.

``load_tables`` reads the cached file and generates it only when it is
missing.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

N_PMJ_SETS = 5
N_PMJ_SAMPLES = 65536
N_BLUENOISE = 48
BLUENOISE_RES = 128

_CACHE = os.path.join(os.path.dirname(__file__), "_tables.npz")


def _reverse_bits32(x: np.ndarray) -> np.ndarray:
    x = ((x >> 16) | (x << 16)) & 0xFFFFFFFF
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    return x


def _owen_scramble(x: np.ndarray, seed: int) -> np.ndarray:
    """Hash-based nested uniform (Owen) scramble, Laine-Karras style."""
    x = _reverse_bits32(x.astype(np.uint64)).astype(np.uint64)
    M = np.uint64(0xFFFFFFFF)
    s = np.uint64(seed & 0xFFFFFFFF)
    x = (x + s) & M
    x = (x ^ (x * np.uint64(0x6C50B47C))) & M
    x = (x ^ (x * np.uint64(0xB82F1E52))) & M
    x = (x ^ (x * np.uint64(0xC7AFE638))) & M
    x = (x ^ (x * np.uint64(0x8D22F6E6))) & M
    return _reverse_bits32(x.astype(np.uint32))


def _sobol_2d(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """First two Sobol dimensions as uint32 (unscrambled)."""
    idx = np.arange(n, dtype=np.uint32)
    # dim 0: bit-reversed van der Corput
    d0 = _reverse_bits32(idx)
    # dim 1: Pascal/Sierpinski generator matrix -- m_k's bit j is
    # binom(k, j) mod 2, i.e. set iff j is a submask of k (Lucas), giving
    # the classic direction numbers 1, 3, 5, 15, 17, 51, 85, 255, ...
    m = []
    for k in range(32):
        mk = 0
        for j in range(k + 1):
            if (j & ~k) == 0:
                mk |= 1 << j
        m.append(mk)
    v = np.array(
        [(m[k] << (31 - k)) & 0xFFFFFFFF for k in range(32)], dtype=np.uint32
    )
    d1 = np.zeros(n, dtype=np.uint32)
    for k in range(32):
        bit = (idx >> k) & 1
        d1 ^= np.where(bit.astype(bool), v[k], 0).astype(np.uint32)
    return d0, d1


def generate_pmj02_tables(
    n_sets: int = N_PMJ_SETS, n: int = N_PMJ_SAMPLES, seed: int = 0
) -> np.ndarray:
    """(n_sets, n, 2) uint32 fixed-point tables (value * 2^-32 in [0,1))."""
    d0, d1 = _sobol_2d(n)
    out = np.zeros((n_sets, n, 2), np.uint32)
    rng = np.random.default_rng(seed)
    for s in range(n_sets):
        s0, s1 = rng.integers(0, 1 << 32, size=2, dtype=np.uint32)
        out[s, :, 0] = _owen_scramble(d0, int(s0))
        out[s, :, 1] = _owen_scramble(d1, int(s1))
    return out


def generate_bluenoise(
    n_tex: int = N_BLUENOISE, res: int = BLUENOISE_RES, seed: int = 0
) -> np.ndarray:
    """(n_tex, res, res) uint16 void-and-cluster rank matrices."""
    rng = np.random.default_rng(seed)
    sigma = 1.9
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    dy = np.minimum(yy, res - yy)
    dx = np.minimum(xx, res - xx)
    kernel = np.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
    kernel_f = np.fft.rfft2(kernel)

    def energy(pattern):
        return np.fft.irfft2(np.fft.rfft2(pattern) * kernel_f, s=(res, res))

    out = np.zeros((n_tex, res, res), np.uint16)
    npx = res * res
    for t in range(n_tex):
        # initial pattern: 10% ones, relaxed by cluster/void swaps
        ones = npx // 10
        pattern = np.zeros(npx, bool)
        pattern[rng.choice(npx, ones, replace=False)] = True
        pattern = pattern.reshape(res, res)
        e = energy(pattern.astype(np.float64))
        for _ in range(npx):  # bounded relaxation
            cluster = np.unravel_index(
                np.argmax(np.where(pattern, e, -np.inf)), e.shape
            )
            pattern[cluster] = False
            e -= np.roll(np.roll(kernel, cluster[0], 0), cluster[1], 1)
            void = np.unravel_index(
                np.argmin(np.where(pattern, np.inf, e)), e.shape
            )
            pattern[void] = True
            e += np.roll(np.roll(kernel, void[0], 0), void[1], 1)
            if void == cluster:
                break

        rank = np.zeros((res, res), np.int32)
        # phase 1: remove tightest clusters, rank ones-1 .. 0
        p1 = pattern.copy()
        e1 = e.copy()
        for r in range(ones - 1, -1, -1):
            cluster = np.unravel_index(
                np.argmax(np.where(p1, e1, -np.inf)), e1.shape
            )
            p1[cluster] = False
            e1 -= np.roll(np.roll(kernel, cluster[0], 0), cluster[1], 1)
            rank[cluster] = r
        # phase 2+3: fill largest voids, rank ones .. npx-1
        p2 = pattern.copy()
        e2 = e.copy()
        for r in range(ones, npx):
            void = np.unravel_index(
                np.argmin(np.where(p2, np.inf, e2)), e2.shape
            )
            p2[void] = True
            e2 += np.roll(np.roll(kernel, void[0], 0), void[1], 1)
            rank[void] = r
        out[t] = ((rank.astype(np.uint64) * 65535) // (npx - 1)).astype(
            np.uint16
        )
    return out


def load_tables(generate: bool = True):
    """Returns (pmj02 (5,65536,2) uint32, bluenoise (48,128,128) uint16)."""
    if os.path.exists(_CACHE):
        z = np.load(_CACHE)
        return z["pmj02"], z["bluenoise"]
    if not generate:
        raise FileNotFoundError(_CACHE)
    pmj = generate_pmj02_tables()
    bn = generate_bluenoise()
    np.savez_compressed(_CACHE, pmj02=pmj, bluenoise=bn)
    return pmj, bn


@functools.lru_cache(maxsize=None)
def _host_tables(n_eff: int):
    """(pmj02 points (5, 65536, 2) float32, blue noise (48, 128, 128)
    float32, the pixel-tile table (tile * tile * n_eff, 2) float32, tile) on
    the host, built once a process for each sample count: they depend on
    neither the seed nor the device. The caller never writes them."""
    pmj_u32, bn_u16 = load_tables()

    def log4i(v):
        return (v.bit_length() - 1) // 2

    def round_up_pow4(v):
        return v if v == 4 ** log4i(v) else 1 << (2 * (1 + log4i(v)))

    tile = 1 << (log4i(N_PMJ_SAMPLES) - log4i(round_up_pow4(n_eff)))
    pix = np.zeros((tile * tile * n_eff, 2), np.float32)
    n_stored = np.zeros(tile * tile, np.int32)
    pts = pmj_u32[0].astype(np.float64) * 2.0**-32
    for i in range(N_PMJ_SAMPLES):
        p = pts[i] * tile
        off = int(p[0]) + int(p[1]) * tile
        if n_stored[off] == n_eff:
            continue
        pix[off * n_eff + n_stored[off]] = p - np.floor(p)
        n_stored[off] += 1
    pmj = (pmj_u32.astype(np.float64) * 2.0**-32).astype(np.float32)
    bn = bn_u16.astype(np.float32) / np.float32(65535.0)
    return pmj, bn, pix, tile


def make_pmj02bn_spec(sample_count: int, seed: int = 1, device="cuda"):
    """The pmj02bn SamplerSpec with its tables on ``device`` (the card unless
    the caller asks for the CPU), replicating
    the sampler's constructor bucketing (sampler.cpp:273-345). The point
    table is computed in float64 and rounded once to float32, and the
    blue-noise table divided by 65535 in float32, as the reference does:
    either step done otherwise moves the last bit of some draws. The host
    tables are built once a process (``_host_tables``); each call copies
    them to ``device``."""
    import torch

    from ..core.device import resolve_device
    from ..utils import metrics
    from .streams import SamplerSpec

    device = resolve_device(device)
    n = min(sample_count, N_PMJ_SAMPLES)
    n_eff = SamplerSpec(kind="pmj02bn", sample_count=n, seed=seed).effective_sample_count
    pmj, bn, pix, tile = _host_tables(n_eff)

    def dev(a):
        with metrics.sync("samplers/tables.py:make_pmj02bn_spec as_tensor"):
            # a CPU tensor would share the cached array's memory
            return torch.as_tensor(a.copy() if device.type == "cpu" else a, device=device)

    return SamplerSpec(
        kind="pmj02bn",
        sample_count=n,
        seed=seed,
        pmj_tables=dev(pmj),
        bluenoise=dev(bn),
        pmj_pixel_table=(dev(pix), tile),
    )
