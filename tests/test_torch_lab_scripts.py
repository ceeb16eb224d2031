"""The port's measuring scripts of this slice on the CPU, at small sizes:
kazen_tpu_torch/lab/megakernel_cliff.py (the port of
benchmarks/megakernel_cliff.py) and kazen_tpu_torch/lab/kernel_ablate.py
(the port of benchmarks/kernel_ablate.py), with the nearest-hit kernel's
nofetch instance's plain version. The CPU runs the plain versions (K3's
``megakernel_plain``, the plain walks), so these tests hold the scripts'
routes, rows and arithmetic, not times.
"""
import json

import numpy as np
import pytest
import torch

from kazen_tpu_torch.accel import cluster_trace as ct
from kazen_tpu_torch.integrate import megakernel as mk
from kazen_tpu_torch.integrate import path_mis as pm
from kazen_tpu_torch.integrate.render import sampler_spec
from kazen_tpu_torch.lab import kernel_ablate as ka
from kazen_tpu_torch.lab import megakernel_cliff as mc
from kazen_tpu_torch.lab import profile_pass2 as pp2
from kazen_tpu_torch.scene.compiler import compile_scene

CLIFF_SIZE = (32, 18)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small renders gain little from intra-op threads; one thread keeps
    them from contending with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gate(label, got, want):
    """PERF.md §2's gate on two passes' per-lane radiance and rays."""
    (a, ra), (b, rb) = got, want
    a, b = a.numpy(), b.numpy()
    share = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, (label, share)
    np.testing.assert_allclose(a.mean(0), b.mean(0), rtol=5e-3, err_msg=label)
    assert abs(float(ra) - float(rb)) <= 1e-3 * float(rb), label


@pytest.fixture(scope="module")
def cliff(tmp_path_factory):
    checked = []
    path = tmp_path_factory.mktemp("cliff") / "cliff.json"
    out = mc.main("cpu", CLIFF_SIZE, json_path=str(path),
                  check=lambda label, got, want: (checked.append(label), _gate(label, got, want)))
    return out, checked, path


def test_cliff_json(cliff):
    out, _, path = cliff
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert out["resolution"] == "32x18" and out["device"] == "cpu"
    for key in ("const", "image_texture"):
        assert set(out[key]) >= {"use_megakernel", "pass_seconds", "rays_per_pass", "rays_per_s"}
        assert len(out[key]["pass_ms"]) == mc.REPS and out[key]["rays_per_pass"] > 0
    assert out["cliff_x"] == pytest.approx(
        out["image_texture"]["pass_seconds"] / out["const"]["pass_seconds"])
    assert out["crossover_faces"] in (None, *(f for _, f in mc.SWEEP))


def test_cliff_routes():
    """The constant box is in the megakernel's class and the textured one
    is not (compiling it for K3 raises); on the CPU render() takes the
    wavefront unless asked (K3 is the card's default)."""
    const = mc.cliff_scene("const", *CLIFF_SIZE)
    scene, static = compile_scene(const, "cpu", megakernel=True)
    assert static.use_megakernel and mk.supported(scene, static)
    assert not compile_scene(const, "cpu")[1].use_megakernel
    textured = mc.cliff_scene("image_texture", *CLIFF_SIZE)
    assert not mk.supported(*compile_scene(textured, "cpu"))
    with pytest.raises(ValueError, match="outside the megakernel's class"):
        compile_scene(textured, "cpu", megakernel=True)


def test_cliff_sweep(cliff):
    """Every sweep size is in the class (at most 128 faces) and went through
    both routes; each K3 pass met the gate against its wavefront pass."""
    out, checked, _ = cliff
    assert [r["faces"] for r in out["sweep"]] == [f for _, f in mc.SWEEP]
    assert len(checked) == len(mc.SWEEP)
    for (sphere, faces), row in zip(mc.SWEEP, out["sweep"]):
        assert faces <= mk.MAX_BRUTE
        assert mk.supported(*compile_scene(mc.sweep_scene(sphere, *CLIFF_SIZE), "cpu"))
        assert row["megakernel"]["use_megakernel"] and not row["wavefront"]["use_megakernel"]
        assert row["megakernel"]["faces"] == row["wavefront"]["faces"] == faces
        assert row["agreement"]["lane_share"] >= 0.99
        assert row["ratio"] == pytest.approx(
            row["wavefront"]["pass_seconds"] / row["megakernel"]["pass_seconds"])


@pytest.fixture(scope="module")
def ablate_scene():
    """The stand-in with a 24 x 12 sphere, at 64x36."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ka, "SPHERE", (24, 12))
        desc = ka.stand_in_scene(64, 36)
    scene, static = compile_scene(desc, "cpu", megakernel=False)
    assert int(scene.F.shape[0]) == 12 + 2 * 24 * 12
    return scene, static, sampler_spec(static, "cpu")


def test_bounce1_sorted_order(ablate_scene):
    """Sorted bounce-1 rays are the bounce-1 state in the stable argsort of
    the packet key: the key never falls along them, live lanes come first
    and lanes with nothing to trace last."""
    scene, static, spec = ablate_scene
    b = pp2.bounce1_state(scene, static, spec)
    key = pm.packet_key(b.pick, b.cluster, b.d, b.alive, b.shadow_maxt)
    order = ka.packet_order(b)
    assert torch.equal(order, torch.argsort(key, stable=True))
    assert bool((key[order][1:] >= key[order][:-1]).all())
    rays = ka.bounce1_rays(scene, static, spec, sort=True)
    unsorted = ka.bounce1_rays(scene, static, spec, sort=False)
    assert rays.shape == unsorted.shape == (8, 64 * 36)
    assert torch.equal(rays, unsorted[:, order])
    live = rays[7] >= 0
    assert int(live.sum()) == int(b.alive.sum()) > 0
    assert bool(live[: int(live.sum())].all())  # live lanes first
    assert bool((rays[6] == static.trace_bias).all())


def test_nofetch_plain_equals_full_rows(ablate_scene):
    """The nofetch instance's plain version equals the plain walk's rows
    NOFETCH_ROWS on every lane: its t is the walk's own, not the
    recompute's, and they agree bit for bit."""
    scene, static, spec = ablate_scene
    tables = scene.trace_tables
    for rays in (ka.bounce1_rays(scene, static, spec), ka.random_rays(2048, "cpu")):
        full = ct.trace_walk_plain(tables, rays)
        part = ct.trace_nofetch_plain(tables, rays)
        assert full.shape == (ct.OUT_ROWS, rays.shape[1]) and part.shape == (6, rays.shape[1])
        assert torch.equal(part, full[list(ct.NOFETCH_ROWS)])
        assert bool((full[3] >= 0).any()) and bool((full[3] < 0).any())  # hits and misses


def test_counts_per_warp():
    """Per-lane means, and the sum over warps of each warp's maximum (the
    last warp ragged), per 1,024 lanes."""
    rows = torch.zeros(ct.OUT_ROWS, 40)
    rows[35, 3] = 5.0  # warp 0's most steps
    rows[35, 33] = 2.0  # warp 1 (8 lanes)
    rows[36, :] = 1.0
    c = ka.counts(rows)
    assert c["steps_warp_max"] == 7.0 and c["tests_warp_max"] == 2.0
    assert c["steps_per_lane"] == pytest.approx(7.0 / 40)
    assert c["steps_per_1024"] == pytest.approx(7.0 * 1024 / 40)


@pytest.mark.parametrize("with_lanes", [False, True])
def test_fit_recovers_known_coefficients(with_lanes):
    """Synthetic launches made by a known split: the fit gives back its
    intercept and per-step and per-test costs (and the per-lane one when it
    is there), with R^2 = 1."""
    rng = np.random.default_rng(3)
    steps = rng.uniform(1e4, 1e6, 12)
    tests = rng.uniform(1e5, 1e7, 12)
    lanes = rng.uniform(1e5, 2e6, 12)
    ms = 0.01 + 3e-7 * steps + 4e-8 * tests + (2e-8 * lanes if with_lanes else 0.0)
    f = ka.fit(ms, steps, tests, lanes)
    assert f["sets"] == 12 and f["r2"] == pytest.approx(1.0)
    assert f["intercept_ms"] == pytest.approx(0.01, rel=1e-6, abs=1e-9)
    assert f["ms_per_warp_step"] == pytest.approx(3e-7, rel=1e-6)
    assert f["ms_per_warp_test"] == pytest.approx(4e-8, rel=1e-6)
    if with_lanes:
        assert f["with_lanes"] and f["ms_per_lane"] == pytest.approx(2e-8, rel=1e-6)
    assert np.abs(f["residuals_ms"]).max() < 1e-9


def test_ablate_main_on_cpu(monkeypatch, tmp_path):
    """The whole script small: the original's set first, the pass's
    launches, bounce 1 at both sizes, random rays and a camera frame, every
    nofetch row equal, the fit over all of them."""
    monkeypatch.setattr(ka, "SPHERE", (24, 12))
    monkeypatch.setattr(ka, "N_RANDOM", 1024)
    path = tmp_path / "ablate.json"
    out = ka.main("cpu", (64, 36), str(path), pass_size=(48, 27), reps=1)
    assert json.loads(path.read_text())["fit"] == json.loads(json.dumps(out["fit"]))
    labels = list(out["rows"])
    assert labels[0] == out["original"] == "bounce 1 sorted 64x36"
    assert {"bounce 1 unsorted 64x36", "bounce 1 sorted 48x27", "bounce 1 unsorted 48x27",
            "camera frame 48x27", "random 1024"} <= set(labels)
    launches = [k for k in labels if k.startswith("pass 48x27 launch")]
    assert len(launches) >= 5 and len(labels) >= 10
    assert out["fit"]["sets"] == len(labels)
    for r in out["rows"].values():
        assert r["nofetch_lanes_differing"] == 0
        assert r["steps_warp_max"] >= r["steps_per_lane"] * r["lanes"] / ka.WARP - 1e-6
    assert out["any_hit_ms"] > 0
