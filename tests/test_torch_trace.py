"""kazen_tpu_torch's cluster trace (plain versions of K1/K2, brute force
and walk) against kazen_tpu's ``trace(..., mode="shim")`` / ``occluded`` and
against each other, and the CUDA kernels against the plain versions where a
card is present."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.accel import cluster_trace as ct_j
from kazen_tpu_torch.accel import cluster_trace as ct_t

from torch_port_helpers import compile_port, compile_reference, multi_cluster_scene


@pytest.fixture(scope="module", params=["invisible_light", "visible_light"])
def tables(request):
    desc = multi_cluster_scene(visible_lights=request.param == "visible_light")
    arrays_j, _ = compile_reference(desc)
    arrays_t, _ = compile_port(desc)
    return arrays_j.trace_tables, arrays_t.trace_tables


def _rays(n, seed, center):
    rng = np.random.RandomState(seed)
    o = np.asarray([center], np.float32) + 0.3 * rng.randn(n, 3).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_trace_matches_shim(tables):
    """Same face and rows 0-33 within rtol 1e-5 / atol 1e-6 on >= 99.9% of
    lanes. Ties between traversal orders may pick another face, and XLA:CPU
    may fuse the reference's products into FMAs, which moves the last bits
    of a grazing hit's (t, u, v)."""
    tt_j, tt_t = tables
    n = 2048
    o, d = _rays(n, 0, [0.0, 1.0, -0.5])
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, 3.0e38, np.float32)
    rj = np.asarray(ct_j.trace(tt_j, jnp.asarray(o), jnp.asarray(d), mint, maxt, mode="shim"))
    rt = ct_t.trace(tt_t, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(mint),
                    torch.from_numpy(maxt)).numpy()
    assert rt.shape == (40, n)
    same = rt[3] == rj[3]
    close = np.isclose(rt[:34], rj[:34], rtol=1e-5, atol=1e-6).all(axis=0)
    assert (same & close).mean() >= 0.999
    assert (rj[3] >= 0).mean() > 0.5
    assert not rt[34:].any()  # diagnostics rows: 0 in the plain version


@pytest.mark.parametrize("maxt", [1.0, 3.0])
def test_occluded_matches_shim(tables, maxt):
    tt_j, tt_t = tables
    n = 2048
    o, d = _rays(n, 1, [0.0, 0.8, 0.0])
    got = ct_t.occluded(tt_t, torch.from_numpy(o), torch.from_numpy(d), 1e-3, maxt).numpy()
    want = np.asarray(
        ct_j.occluded(tt_j, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.full(n, maxt), mode="shim")
    )
    assert (got == want).mean() >= 0.999
    assert 0.05 < want.mean() < 0.95


def test_occluded_light_faces(tables, request):
    """A shadow ray that reaches the light before anything else: a
    primary-invisible light never blocks it, a visible one does."""
    _, tt_t = tables
    visible = request.node.callspec.id == "visible_light"
    n = 16
    xs = np.linspace(-0.25, 0.25, n, dtype=np.float32)
    o = torch.from_numpy(np.stack([xs, np.full(n, 1.5, np.float32), np.zeros(n, np.float32)], 1))
    d = torch.tensor([[0.0, 1.0, 0.0]]).expand(n, 3)
    blocked = ct_t.occluded(tt_t, o, d, 1e-3, 0.49)  # light at 0.48, ceiling at 0.5
    assert bool((blocked == visible).all())
    rows = ct_t.trace(tt_t, o, d, 1e-3, 3.0e38)
    assert bool((rows[28] >= 0).all())  # the nearest hit is the light either way
    np.testing.assert_allclose(rows[0].numpy(), 0.48, rtol=1e-5)


def test_miss_sentinel(tables):
    """Missed lanes: face/light -1, t = BIG, the benign unit triangle."""
    _, tt_t = tables
    n = 8
    o = torch.tensor([[0.0, 1.0, -2.5]]).expand(n, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3)
    rows = ct_t.trace(tt_t, o, d, 1e-4, 3.0e38)
    assert bool((rows[3] == -1).all()) and bool((rows[28] == -1).all())
    assert bool((rows[0] == ct_t.BIG).all())
    for r in (3, 7, 11, 14, 17):
        assert bool((rows[4 + r] == 1.0).all())
    dead = ct_t.trace(tt_t, o, -d, 1e-4, -1.0)  # maxt < 0: never hits
    assert bool((dead[3] == -1).all())


def test_plain_chunking_is_exact(tables, monkeypatch):
    """The plain versions give the same bits whatever their chunk sizes."""
    _, tt_t = tables
    o, d = _rays(300, 2, [0.0, 1.0, 0.0])
    rays = ct_t.pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-4, 2.0)
    whole_t = ct_t.trace_plain(tt_t, rays)
    whole_o = ct_t.occluded_plain(tt_t, rays)
    monkeypatch.setattr(ct_t, "_chunks", lambda tables, n, device: (37, 3))
    assert torch.equal(ct_t.trace_plain(tt_t, rays), whole_t)
    assert torch.equal(ct_t.occluded_plain(tt_t, rays), whole_o)


def test_cpu_tensors_take_the_plain_version(tables):
    """A CPU tensor goes to the plain version and launches nothing."""
    _, tt_t = tables
    o, d = _rays(64, 3, [0.0, 1.0, -2.0])
    rays = ct_t.pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-4, 3.0e38)
    before = (ct_t.NEAREST.launches, ct_t.ANY_HIT.launches)
    assert torch.equal(ct_t.trace_rays(tt_t, rays), ct_t.trace_plain(tt_t, rays))
    assert torch.equal(ct_t.occluded_rays(tt_t, rays), ct_t.occluded_plain(tt_t, rays))
    assert (ct_t.NEAREST.launches, ct_t.ANY_HIT.launches) == before


@pytest.mark.parametrize(
    "bad",
    ["dtype", "rows", "contiguous", "device"],
)
def test_kernel_wrapper_checks_inputs(tables, bad):
    _, tt_t = tables
    rays = torch.zeros(8, 16)
    if bad == "dtype":
        rays = rays.double()
    elif bad == "rows":
        rays = torch.zeros(7, 16)
    elif bad == "contiguous":
        rays = torch.zeros(16, 8).T
    msg = {"dtype": "float32", "rows": r"\(8, N\)", "contiguous": "contiguous", "device": "CUDA"}
    with pytest.raises(ValueError, match=msg[bad]):
        ct_t._check_inputs(tt_t, rays)


def _walk_rays(n, seed, center, maxt):
    """Seeded rays packed (8, N) with their first 16 lanes dead (maxt < 0)."""
    o, d = _rays(n, seed, center)
    mx = np.full(n, maxt, np.float32)
    mx[:16] = -1.0
    return o, d, ct_t.pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                                torch.from_numpy(mx))


def test_walk_matches_trace_plain(tables):
    """The plain walk (the kernels' traversal) against the brute force: same
    face and rows 0-33 bit for bit on >= 99.9% of lanes (ties between
    traversal orders may pick another face); the any hit agrees on >= 99.9%
    of lanes."""
    _, tt_t = tables
    _, _, rays = _walk_rays(2048, 5, [0.0, 1.0, -0.5], 3.0e38)
    walk, brute = ct_t.trace_walk_plain(tt_t, rays), ct_t.trace_plain(tt_t, rays)
    assert walk.shape == (40, 2048)
    assert (walk[:34] == brute[:34]).all(0).float().mean().item() >= 0.999
    assert (brute[3] >= 0).float().mean().item() > 0.5
    assert not walk[37:].any()
    short = rays.clone()
    short[7, 16:] = 1.0
    a, b = ct_t.occluded_walk_plain(tt_t, short), ct_t.occluded_plain(tt_t, short)
    assert (a[0] == b[0]).float().mean().item() >= 0.999
    assert 0.05 < b[0].mean().item() < 0.95
    assert not a[4:].any()


def test_walk_matches_shim(tables):
    """The plain walk against kazen_tpu's shim, with the limits of
    test_trace_matches_shim."""
    tt_j, tt_t = tables
    n = 2048
    o, d = _rays(n, 0, [0.0, 1.0, -0.5])
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, 3.0e38, np.float32)
    rj = np.asarray(ct_j.trace(tt_j, jnp.asarray(o), jnp.asarray(d), mint, maxt, mode="shim"))
    rays = ct_t.pack_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(mint),
                          torch.from_numpy(maxt))
    rt = ct_t.trace_walk_plain(tt_t, rays).numpy()
    same = rt[3] == rj[3]
    close = np.isclose(rt[:34], rj[:34], rtol=1e-5, atol=1e-6).all(axis=0)
    assert (same & close).mean() >= 0.999
    assert (rj[3] >= 0).mean() > 0.5


@pytest.mark.parametrize("maxt", [1.0, 3.0])
def test_occluded_walk_matches_shim(tables, maxt):
    tt_j, tt_t = tables
    n = 2048
    o, d = _rays(n, 1, [0.0, 0.8, 0.0])
    rays = ct_t.pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-3, maxt)
    got = ct_t.occluded_walk_plain(tt_t, rays)[0].numpy() > 0.0
    want = np.asarray(
        ct_j.occluded(tt_j, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.full(n, maxt), mode="shim")
    )
    assert (got == want).mean() >= 0.999
    assert 0.05 < want.mean() < 0.95


def test_walk_diagnostics(tables):
    """Visits, node steps and triangle tests of the plain walks: integers,
    non-negative, tests <= 128 x visits, visits <= steps; dead lanes walk
    nothing and live lanes step at least once."""
    _, tt_t = tables
    _, _, rays = _walk_rays(1024, 6, [0.0, 1.0, 0.0], 3.0e38)
    near = ct_t.trace_walk_plain(tt_t, rays)[34:37]
    short = rays.clone()
    short[7, 16:] = 0.7
    anyh = ct_t.occluded_walk_plain(tt_t, short)[1:4]
    for visits, steps, tests in (near, anyh):
        for row in (visits, steps, tests):
            assert bool((row >= 0).all()) and torch.equal(row, row.round())
        assert bool((tests <= ct_t.K * visits).all())
        assert bool((visits <= steps).all())
        assert not (visits[:16].any() or steps[:16].any() or tests[:16].any())
        assert bool((steps[16:] >= 1).all())
        assert visits.sum() > 0 and tests.sum() > 0
    # the nearest hit tests every triangle of a visited cluster
    assert bool((near[2] >= near[0]).all())


@pytest.mark.cuda
def test_kernels_match_plain_on_card(tables):
    """K1/K2 on the card, draining every leaf serially (min_idle 33) and
    every leaf cooperatively (min_idle 0), against their plain versions (the
    limits of chip_smoke.py's phase 1) and their plain walks (rows 0-36,
    any hit 0-3, on >= 99.99% of lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace kernels have no CPU mode")
    _, tt_t = tables
    tt = tt_t.to("cuda")
    o, d = _rays(4096, 4, [0.0, 1.0, -2.0])
    rays = ct_t.pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-4, 3.0e38).cuda()
    short = rays.clone()
    short[7] = 1.5
    rp, op = ct_t.trace_plain(tt, rays), ct_t.occluded_plain(tt, short)[0]
    rw, ow = ct_t.trace_walk_plain(tt, rays), ct_t.occluded_walk_plain(tt, short)
    for min_idle in (0, 33):
        rk = ct_t.trace_cuda(tt, rays, min_idle)
        torch.cuda.synchronize()
        same = rk[3] == rp[3]
        assert same.float().mean().item() >= 0.99
        torch.testing.assert_close(rk[:34, same], rp[:34, same], rtol=1e-4, atol=1e-4)
        assert (rk[:37] == rw[:37]).all(0).float().mean().item() >= 0.9999
        ok = ct_t.occluded_cuda(tt, short, min_idle)
        assert (ok[0] == op).float().mean().item() >= 0.999
        assert (ok[:4] == ow[:4]).all(0).float().mean().item() >= 0.9999
