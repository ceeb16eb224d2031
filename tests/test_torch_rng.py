"""kazen_tpu_torch's random streams against kazen_tpu's, bit for bit.

The port holds every 64-bit value as the int64 with the same bits; the
reference holds (hi, lo) uint32 pairs. Inputs are made with numpy from a
seed and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.core import rng as rng_j
from kazen_tpu.core import u64
from kazen_tpu.samplers import streams as streams_j
from kazen_tpu_torch.core import rng as rng_t
from kazen_tpu_torch.samplers import streams as streams_t

RNG = np.random.default_rng(11)


def _u64_of_pair(pair):
    hi = np.asarray(pair[0]).astype(np.uint64)
    lo = np.asarray(pair[1]).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def _pair_of_u64(vals):
    vals = np.asarray(vals, np.uint64)
    return (
        jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def _t64(vals):
    """numpy uint64 -> the port's int64 lanes with the same bits."""
    return torch.from_numpy(np.asarray(vals, np.uint64).view(np.int64).copy())


def _rand_u64(n):
    return RNG.integers(0, np.iinfo(np.uint64).max, size=n, dtype=np.uint64, endpoint=True)


def _pixels(n):
    pts = RNG.integers(0, 4096, size=(n, 2))
    return pts[:, 0], pts[:, 1]


def test_mix_bits_bit_exact():
    xs = _rand_u64(256)
    want = _u64_of_pair(rng_j.mix_bits(_pair_of_u64(xs)))
    np.testing.assert_array_equal(rng_t.to_u64(rng_t.mix_bits(_t64(xs))), want)


@pytest.mark.parametrize("seed", [0, 1, 12345, (1 << 64) - 17])
def test_hash_pixel_seed_bit_exact(seed):
    px, py = _pixels(128)
    want = _u64_of_pair(
        rng_j.hash_pixel_seed(px.astype(np.uint32), py.astype(np.uint32), seed)
    )
    got = rng_t.hash_pixel_seed(torch.from_numpy(px), torch.from_numpy(py), seed)
    np.testing.assert_array_equal(rng_t.to_u64(got), want)


@pytest.mark.parametrize("dim", [0, 3, 77])
def test_hash_pixel_dim_seed_bit_exact(dim):
    px, py = _pixels(64)
    pxt, pyt = torch.from_numpy(px), torch.from_numpy(py)
    for seed in (1, 98765, (1 << 64) - 3):
        want = _u64_of_pair(
            rng_j.hash_pixel_dim_seed(px.astype(np.uint32), py.astype(np.uint32), dim, seed)
        )
        np.testing.assert_array_equal(
            rng_t.to_u64(rng_t.hash_pixel_dim_seed(pxt, pyt, dim, seed)), want
        )
        # per-lane dims take the same key layout
        np.testing.assert_array_equal(
            rng_t.to_u64(rng_t.hash_pixel_dim_seed(pxt, pyt, torch.full_like(pxt, dim), seed)),
            want,
        )


def test_pcg_draws_bit_exact():
    hs = _rand_u64(64)
    st_j = rng_j.pcg_seed(_pair_of_u64(hs))
    st_t = rng_t.pcg_seed(_t64(hs))
    for _ in range(24):
        st_j, uj = rng_j.pcg_next_uint(st_j)
        st_t, ut = rng_t.pcg_next_uint(st_t)
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj).astype(np.int64))
        st_j, fj = rng_j.pcg_next_float(st_j)
        st_t, ft = rng_t.pcg_next_float(st_t)
        assert ft.dtype == torch.float32
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(rng_t.to_u64(st_t[0]), _u64_of_pair(st_j[0]))
    np.testing.assert_array_equal(rng_t.to_u64(st_t[1]), _u64_of_pair(st_j[1]))


@pytest.mark.parametrize("delta", [0, 1, 5, 65536, 65536 * 3 + 4, (1 << 40) + 12345])
def test_advance_constants_and_jump_bit_exact(delta):
    assert rng_t.advance_constants(delta) == rng_j.advance_constants(delta)
    hs = _rand_u64(32)
    a, s = rng_j.advance_constants(delta)
    st_j = rng_j.pcg_advance_jump(
        rng_j.pcg_seed(_pair_of_u64(hs)), u64.from_int(a), u64.from_int(s)
    )
    st_t = rng_t.pcg_advance_jump(rng_t.pcg_seed(_t64(hs)), a, s)
    np.testing.assert_array_equal(rng_t.to_u64(st_t[0]), _u64_of_pair(st_j[0]))
    st_s = rng_j.pcg_advance_static(rng_j.pcg_seed(_pair_of_u64(hs)), delta)
    np.testing.assert_array_equal(
        rng_t.to_u64(rng_t.pcg_advance(rng_t.pcg_seed(_t64(hs)), delta)[0]),
        _u64_of_pair(st_s[0]),
    )


@pytest.mark.parametrize("l", [1, 2, 7, 16, 100, 1024])
def test_permute_bit_exact(l):
    p = RNG.integers(0, 1 << 32, size=l)
    idx = np.arange(l)
    want = np.asarray(rng_j.permute(idx.astype(np.uint32), l, p.astype(np.uint32)))
    got = rng_t.permute(torch.from_numpy(idx), l, torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # one key for all lanes: a permutation of [0, l)
    got1 = rng_t.permute(torch.from_numpy(idx), l, torch.tensor(int(p[0])))
    assert sorted(got1.tolist()) == list(range(l))


def test_tea32_bit_exact():
    vs = RNG.integers(0, 1 << 32, size=(64, 2))
    hi_j, lo_j = rng_j.sample_tea32(vs[:, 0].astype(np.uint32), vs[:, 1].astype(np.uint32))
    hi_t, lo_t = rng_t.sample_tea32(torch.from_numpy(vs[:, 0]), torch.from_numpy(vs[:, 1]))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j).astype(np.int64))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j).astype(np.int64))


@pytest.mark.parametrize(
    "kind,spp", [("independent", 4), ("stratified", 9), ("correlated", 6)]
)
def test_stream_draws_bit_exact(kind, spp):
    """Sampler stream draws (1D, 2D and the pixel draw) of every ported
    kind, over several sample indices, equal kazen_tpu's exactly."""
    px, py = _pixels(96)
    spec_j = streams_j.SamplerSpec(kind=kind, sample_count=spp, seed=3)
    spec_t = streams_t.SamplerSpec(kind=kind, sample_count=spp, seed=3)
    assert spec_t.effective_sample_count == spec_j.effective_sample_count
    for s in (0, 1, spp - 1):
        st_j = streams_j.init_stream(spec_j, px.astype(np.uint32), py.astype(np.uint32), s)
        st_t = streams_t.init_stream(spec_t, torch.from_numpy(px), torch.from_numpy(py), s)
        for step in range(6):
            if step % 3 == 0:
                st_j, uj = streams_j.next_pixel_2d(spec_j, st_j)
                st_t, ut = streams_t.next_pixel_2d(spec_t, st_t)
            elif step % 3 == 1:
                st_j, uj = streams_j.next_1d(spec_j, st_j)
                st_t, ut = streams_t.next_1d(spec_t, st_t)
            else:
                st_j, uj = streams_j.next_2d(spec_j, st_j)
                st_t, ut = streams_t.next_2d(spec_t, st_t)
            np.testing.assert_array_equal(ut.numpy(), np.asarray(uj), err_msg=f"{s} {step}")
        np.testing.assert_array_equal(st_t.dim.numpy(), np.asarray(st_j.dim).astype(np.int64))


def test_unported_sampler_raises():
    """Every sampler kind of the reference is ported (pmj02bn's streams are
    held in test_torch_samplers.py); an unknown kind is refused."""
    assert streams_t.SamplerSpec(kind="pmj02bn", sample_count=4).effective_sample_count == 4
    with pytest.raises(ValueError, match="unknown sampler kind"):
        streams_t.SamplerSpec(kind="sobol")
