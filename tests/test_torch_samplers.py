"""kazen_tpu_torch's pmj02bn sampler against kazen_tpu's: the table file,
the spec's tables and every stream draw, bit for bit."""
import filecmp
import os

import numpy as np
import pytest
import torch

from kazen_tpu.samplers import streams as streams_j
from kazen_tpu.samplers import tables as tables_j
from kazen_tpu_torch.samplers import streams as streams_t
from kazen_tpu_torch.samplers import tables as tables_t

from torch_port_helpers import compile_port, compile_reference, multi_cluster_scene


def test_table_file_is_the_references():
    assert filecmp.cmp(tables_t._CACHE, tables_j._CACHE, shallow=False)
    assert os.path.getsize(tables_t._CACHE) == 4_194_577
    for got, want in zip(tables_t.load_tables(generate=False), tables_j.load_tables(generate=False)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def specs():
    return {
        spp: (tables_j.make_pmj02bn_spec(spp, seed=3),
              tables_t.make_pmj02bn_spec(spp, seed=3, device="cpu"))
        for spp in (1, 4, 16, 64)
    }


@pytest.mark.parametrize("spp", [1, 4, 16, 64])
def test_spec_tables_equal(specs, spp):
    """The point table (float64 product rounded once to float32), the
    blue-noise table (float32 division by 65535) and the pixel-tile table
    with its tile size, equal to the reference's."""
    sj, st = specs[spp]
    assert st.effective_sample_count == sj.effective_sample_count == spp
    for name in ("pmj_tables", "bluenoise"):
        got, want = getattr(st, name), np.asarray(getattr(sj, name))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    (tile_t, size_t), (tile_j, size_j) = st.pmj_pixel_table, sj.pmj_pixel_table
    assert size_t == size_j
    np.testing.assert_array_equal(tile_t.numpy(), np.asarray(tile_j))


def test_spec_equality_ignores_tables(specs):
    _, st = specs[4]
    bare = streams_t.SamplerSpec(kind="pmj02bn", sample_count=4, seed=3)
    assert bare == st and hash(bare) == hash(st)
    assert bare != streams_t.SamplerSpec(kind="pmj02bn", sample_count=4, seed=4)


def test_host_tables_are_built_once_and_never_shared(specs):
    """A second spec of the same sample count, at another seed, reuses the
    host tables without rebuilding them and equals the first; its CPU
    tensors are its own, so writing one leaves the cache as it was."""
    _, st = specs[16]
    built = tables_t._host_tables.cache_info().misses
    again = tables_t.make_pmj02bn_spec(16, seed=11, device="cpu")
    assert tables_t._host_tables.cache_info().misses == built
    assert again.seed == 11 and again.pmj_pixel_table[1] == st.pmj_pixel_table[1]
    for got, want in ((again.pmj_tables, st.pmj_tables), (again.bluenoise, st.bluenoise),
                      (again.pmj_pixel_table[0], st.pmj_pixel_table[0])):
        assert torch.equal(got, want) and got.data_ptr() != want.data_ptr()
    again.pmj_tables.zero_()
    assert torch.equal(tables_t.make_pmj02bn_spec(16, seed=3, device="cpu").pmj_tables,
                       st.pmj_tables)


def _pixels():
    """Pixels beyond the blue-noise period (128) and the pixel tiles, plus
    the lane-chunked pass's off-image padding column."""
    rng = np.random.RandomState(5)
    px = np.concatenate([rng.randint(0, 300, 200), [0x7FFFFF, 127, 128]]).astype(np.int64)
    py = np.concatenate([rng.randint(0, 300, 200), [0, 127, 128]]).astype(np.int64)
    return px, py


@pytest.mark.parametrize("spp,s", [(4, 3), (64, 0)])
def test_pmj02bn_streams_bit_exact(specs, spp, s):
    """init_stream, the pixel draw and 1D/2D draws over 60 dimensions (past
    the 5 point sets, where the index is permuted, and past the 48 blue-noise
    tables), equal kazen_tpu's exactly."""
    sj, st = specs[spp]
    px, py = _pixels()
    if True:
        st_j = streams_j.init_stream(sj, px.astype(np.uint32), py.astype(np.uint32), s)
        st_t = streams_t.init_stream(st, torch.from_numpy(px), torch.from_numpy(py), s)
        np.testing.assert_array_equal(st_t.dim.numpy(), 2)
        for step in range(50):
            if step % 4 == 0:
                st_j, uj = streams_j.next_pixel_2d(sj, st_j)
                st_t, ut = streams_t.next_pixel_2d(st, st_t)
            elif step % 4 == 1:
                st_j, uj = streams_j.next_1d(sj, st_j)
                st_t, ut = streams_t.next_1d(st, st_t)
            else:
                st_j, uj = streams_j.next_2d(sj, st_j)
                st_t, ut = streams_t.next_2d(st, st_t)
            assert ut.dtype == torch.float32
            np.testing.assert_array_equal(ut.numpy(), np.asarray(uj), err_msg=f"{s} {step}")
        np.testing.assert_array_equal(st_t.dim.numpy(), np.asarray(st_j.dim).astype(np.int64))
        assert int(st_t.dim[0]) > 60


def test_pmj02bn_scene_compiles_to_the_references_spec():
    """A pmj02bn scene compiles on both sides to the same static sampler
    fields, and the port's render.sampler_spec builds the tables on the
    scene's device."""
    from kazen_tpu.integrate import render as render_j
    from kazen_tpu_torch.integrate import render as render_t

    desc = multi_cluster_scene(width=8, height=8, sampler="pmj02bn", spp=16)
    (_, s_j), (a_t, s_t) = compile_reference(desc), compile_port(desc)
    assert (s_t.sampler_kind, s_t.sample_count, s_t.seed) == ("pmj02bn", 16, s_j.seed)
    sj, st = render_j.sampler_spec(s_j), render_t.sampler_spec(s_t, a_t.device)
    assert st == streams_t.SamplerSpec(kind="pmj02bn", sample_count=16, seed=s_j.seed)
    np.testing.assert_array_equal(st.pmj_pixel_table[0].numpy(), np.asarray(sj.pmj_pixel_table[0]))
