"""kazen_tpu_torch's staged wavefront driver (integrate/staged.py): on the
CPU it equals the port's li_wavefront per lane, bit for bit, in sync and in
pipelined mode, while narrowing late bounces; a schedule too narrow for a
pass is caught by PassRecord.ok; and it agrees with kazen_tpu's li_staged
within test_torch_render.py's limits (rtol 1e-3 / atol 1e-4 on >= 99% of
lanes, channel means within 0.5%, rays within 0.1%)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.integrate import camera as cam_j
from kazen_tpu.integrate import render as render_j
from kazen_tpu.integrate import staged as staged_j
from kazen_tpu.samplers import streams as streams_j
from kazen_tpu_torch.integrate import camera as cam_t
from kazen_tpu_torch.integrate import path_mis as pm_t
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.integrate import staged as staged_t
from kazen_tpu_torch.samplers import streams as streams_t

from torch_port_helpers import (
    compile_port,
    compile_reference,
    multi_cluster_scene,
    single_cluster_scene,
)


def _lanes_port(scene, static, sample=0):
    spec = render_t.sampler_spec(static, "cpu")
    px, py = render_t.pixel_grid(static, scene.device)
    st = streams_t.init_stream(spec, px, py, sample)
    st, jitter = streams_t.next_pixel_2d(spec, st)
    st, ap = streams_t.next_2d(spec, st)
    ps = torch.stack([px, py], -1).to(torch.float32) + jitter
    return spec, st, cam_t.sample_ray(scene, static, ps, ap)


def _driver(static, spec, n):
    return staged_t.StagedWavefront(
        static, n,
        lambda sc, stream, rays: (pm_t.wavefront_init(sc, static, spec, stream, rays),),
        lambda sc, st: pm_t.wavefront_finish(sc, static, st),
    )


@pytest.fixture(scope="module")
def multi():
    """48x48 lanes (2,304): the width menu is [2304, 2048, 1024]."""
    desc = multi_cluster_scene(width=48, height=48)
    return desc, compile_port(desc)


def _assert_equal_to_wavefront(scene, static, out):
    spec, st, rays = _lanes_port(scene, static)
    _, li_w, nr_w = pm_t.li_wavefront(scene, static, spec, st, rays)
    _, li_s, nr_s = out
    assert torch.equal(li_s, li_w)
    assert float(nr_s) == float(nr_w)
    assert li_w.mean() > 0.01


def test_sync_mode_equals_wavefront_and_narrows(multi):
    _, (a_t, s_t) = multi
    spec, st, rays = _lanes_port(a_t, s_t)
    n = rays.o.shape[0]
    sw = _driver(s_t, spec, n)
    assert sw.widths == [2304, 2048, 1024]
    out, rec = sw.run(a_t, spec, st, rays)
    _assert_equal_to_wavefront(a_t, s_t, out)
    assert rec.widths[0] == n and min(rec.widths) < n, rec.widths
    assert len(rec.widths) == s_t.max_depth
    counts = rec._ints()
    # each bounce after the first ran on the smallest menu width covering
    # the lanes alive after the bounce before
    for k in range(1, len(rec.widths)):
        assert rec.widths[k] == sw._pick(counts[k - 1])
    assert rec.ok()


def test_pipelined_mode_equals_wavefront(multi):
    """A schedule planned from one pass runs the next with no sync between
    bounces, checks ok(), and equals the wavefront per lane."""
    _, (a_t, s_t) = multi
    spec, st, rays = _lanes_port(a_t, s_t)
    sw = _driver(s_t, spec, rays.o.shape[0])
    _, rec = sw.run(a_t, spec, st, rays)
    plan = rec.plan()
    assert plan[0] == sw.n and min(plan) < sw.n
    out, rec2 = sw.run(a_t, spec, st, rays, widths=plan)
    assert rec2.widths == plan
    assert all(isinstance(c, torch.Tensor) for c in rec2.counts)  # no sync
    assert rec2.ok()
    _assert_equal_to_wavefront(a_t, s_t, out)


def test_too_narrow_schedule_is_not_ok(multi):
    _, (a_t, s_t) = multi
    spec, st, rays = _lanes_port(a_t, s_t)
    sw = _driver(s_t, spec, rays.o.shape[0])
    _, rec = sw.run(a_t, spec, st, rays, widths=[sw.n, 1024, 1024, 1024, 1024])
    assert not rec.ok()
    # a schedule that ends while lanes are alive fails too
    _, rec = sw.run(a_t, spec, st, rays, widths=[sw.n, sw.n])
    assert not rec.ok()


def test_single_cluster_fallback():
    """One cluster: no permute, so no alive-first prefix; every bounce runs
    at full width, even when a schedule asks for less."""
    a_t, s_t = compile_port(single_cluster_scene(width=40, height=40))
    assert not pm_t._ordering_useful(a_t)
    spec, st, rays = _lanes_port(a_t, s_t)
    n = rays.o.shape[0]
    sw = _driver(s_t, spec, n)
    assert len(sw.widths) > 1
    out, rec = sw.run(a_t, spec, st, rays)
    assert rec.widths == [n] * s_t.max_depth
    _assert_equal_to_wavefront(a_t, s_t, out)
    out, rec = sw.run(a_t, spec, st, rays, widths=[n, 1024, 1024])
    assert rec.widths == [n] * s_t.max_depth and rec.ok()
    _assert_equal_to_wavefront(a_t, s_t, out)


@pytest.mark.parametrize("n", [576, 2304, 8192, 2_073_600])
def test_width_menu_and_plan_match_reference(n):
    """_default_widths, plan() and ok() are the reference's, given the same
    alive counts."""
    assert staged_t._default_widths(n) == staged_j._default_widths(n)
    sw_j = staged_j.StagedWavefront(None, n, lambda *a: a, lambda *a: a)
    sw_t = staged_t.StagedWavefront(None, n, lambda *a: a, lambda *a: a)
    rng = np.random.RandomState(n % 1000)
    for _ in range(30):
        ran = rng.randint(1, 6)  # bounces the pass ran (a schedule may end early)
        counts = np.sort(rng.randint(0, n + 1, ran))[::-1].tolist()
        if rng.rand() < 0.3:
            k = rng.randint(0, ran)
            counts = counts[:k] + [0] * (ran - k)
        widths = [n] + [int(w) for w in rng.choice(sw_t.widths, ran - 1)]
        rj = staged_j.PassRecord(sw_j, widths, counts, 5)
        rt = staged_t.PassRecord(sw_t, widths, counts, 5)
        assert rt.plan() == rj.plan()
        assert rt.ok() == rj.ok()


def test_staged_matches_reference(multi):
    """The port's li_staged against kazen_tpu's on the CPU."""
    desc, (a_t, s_t) = multi
    a_j, s_j = compile_reference(desc)
    spec_j = render_j.sampler_spec(s_j)
    ys, xs = np.meshgrid(np.arange(s_j.height), np.arange(s_j.width), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    st_j = streams_j.init_stream(spec_j, px.astype(np.uint32), py.astype(np.uint32), 0)
    st_j, jitter = streams_j.next_pixel_2d(spec_j, st_j)
    ps = jnp.stack([jnp.asarray(px), jnp.asarray(py)], -1).astype(jnp.float32) + jitter
    st_j, ap = streams_j.next_2d(spec_j, st_j)
    _, li_j, nr_j = staged_j.li_staged(a_j, s_j, spec_j, st_j, cam_j.sample_ray(a_j, s_j, ps, ap))
    li_j = np.asarray(li_j)

    _, li_t, nr_t = staged_t.li_staged(a_t, s_t, *_lanes_port(a_t, s_t))
    li_t = li_t.numpy()
    lanes = np.isclose(li_t, li_j, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert lanes.mean() >= 0.99, lanes.mean()
    np.testing.assert_allclose(li_t.mean(0), li_j.mean(0), rtol=5e-3)
    assert abs(float(nr_t) - float(nr_j)) <= 1e-3 * float(nr_j)
    assert li_j.mean() > 0.01
