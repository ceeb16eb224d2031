"""BASELINE's configuration 3 (kazen-con-1: an image-textured kiss with
clearcoat and sheen, a normal-mapped kiss, a thin lens) as the benchmark
runs it, on the CPU at a small size: the scene and its routes through the
port, its reference (``kzbench/reference/render_con1.py``) against the
port's render() and its eye for both features, the cell's limits against
the control and the planted faults, the shade kernel's launches as the
traced window captures them (the kernel's source built for the host), the
bytes bound and its reader, and the program's tracer on the scene."""
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kazen_tpu_torch.examples import baseline_configs as bc
from kazen_tpu_torch.integrate import camera as camera_t
from kazen_tpu_torch.integrate import megakernel as mk
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.scene import description as PD
from kazen_tpu_torch.scene.compiler import compile_numpy, compile_scene
from kazen_tpu_torch.shade import bounce_kernel
from kazen_tpu_torch.shade import bsdf as bsdf_t
from kazen_tpu_torch.utils import metrics
from kzbench import control, faults, harness, registry, shade_roofline
from kzbench.entries import render as render_entry
from kzbench.entries import render_con1 as con1_entry
from kzbench.profile import Activity, Records
from kzbench.reference import render_con1 as ref
from kzbench.scenes import kiss3

import shade_host
import torch_port_helpers  # noqa: F401 (the port tests' torch-thread policy)

CELL = "kiss3.render_2160p_thinlens"
SMALL = ({"width": 16, "height": 12, "spp": 2}, {"check_pixels": 16 * 12})
W, H = 32, 18  # the program against the reference, every pixel
SEEDS = (3000000019, 2718281828)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(seed, width=W, height=H, **changes):
    return dict(registry.config("kiss3"), width=width, height=height, seed=seed, **changes)


def pixels(width=W, height=H):
    ys, xs = torch.meshgrid(torch.arange(height), torch.arange(width), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], 1)


def reference(cfg):
    scene, static = ref.compile_reference(kiss3.build, cfg, torch.device("cpu"))
    return ref.pixel_values(scene, static, pixels(cfg["width"], cfg["height"]), 2)


def seeded_images(seed):
    """kiss3's image builder with texels drawn from ``seed`` in place of the
    checker and the bump: the base colour's in [0, 1), the normal map's
    flat normal tilted by up to 0.3 in x and y."""
    rng = np.random.default_rng(seed)

    def image(D, spec):
        n = spec["size"]
        if spec["image"] == "bump":
            img = np.full((n, n, 3), spec["flat"], np.float32)
            img[..., :2] += rng.uniform(-0.3, 0.3, (n, n, 2)).astype(np.float32)
        else:
            img = rng.uniform(0.0, 1.0, (n, n, 3)).astype(np.float32)
        return D.ImageTexture(data=img, colorspace="linear")

    return image


def program_image(cfg):
    """(image (H*W, 3), whether some lane's frame was perturbed) of the
    port's render() of ``cfg``, two passes on the CPU."""
    arrays, static = compile_scene(kiss3.build(PD, cfg), device="cpu")
    perturbed, make_ctx = [], bsdf_t.make_ctx

    def spy(*args, **kwargs):
        ctx = make_ctx(*args, **kwargs)
        perturbed.append(bool(ctx.perturbed.any()))
        return ctx

    bsdf_t.make_ctx = spy
    try:
        img = render_t.render(arrays, static, spp=2, device="cpu").reshape(-1, 3)
    finally:
        bsdf_t.make_ctx = make_ctx
    return img, any(perturbed)


@pytest.fixture(scope="module")
def program():
    return {seed: program_image(config(seed)) for seed in SEEDS}


def test_the_scene_is_config_3():
    """The benchmark's builder, given the port's classes, compiles to what
    ``examples/baseline_configs.py:config_scene(3)`` compiles to at the
    cell's frame."""
    cfg = dict(registry.config("kiss3"), seed=1)
    got_a, got_s = compile_numpy(kiss3.build(PD, cfg))
    want_a, want_s = compile_numpy(bc.at_size(bc.config_scene(3), cfg["width"], cfg["height"]))
    assert got_s == want_s
    for key, want in want_a.items():
        got = got_a[key]
        if isinstance(want, dict):
            assert set(got) == set(want), key
            for k in want:
                assert (got[k] == want[k]).all(), (key, k)
        elif want is not None:
            assert (got == want).all(), key
    assert len(got_a["F"]) == registry.config("kiss3")["faces"] == 4428
    assert (got_s["width"], got_s["height"]) == (3840, 2160)


def test_the_scene_takes_the_wavefront_and_the_shade_kernel():
    """4,428 faces and image textures put the scene outside the megakernel's
    class; the image-textured base colour and the normal map are in the
    shade kernel's."""
    desc = kiss3.build(PD, config(1, 512, 512))
    arrays, static = compile_scene(desc, device="cpu")
    assert not static.use_megakernel
    assert not mk.supported_reason(arrays, static)[0] and arrays.F.shape[0] > mk.MAX_BRUTE
    assert static.camera_kind == "thinlens" and static.sampler_kind == "independent"
    assert static.textured_fields == ("base", "normal")
    assert static.mip_textures and static.aniso_textures
    assert bounce_kernel.supported_reason(arrays, static) == (True, "supported")


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_matches_the_programs_plain_path(program, seed):
    """32x18, two passes: the reference at every pixel against the port's
    render() on the CPU, within the cell's limits and at the tolerance
    con-2's reference is held to; the normal map perturbs some lanes'
    frames, and the thin lens moves the camera rays' origins off the
    pinhole."""
    img, perturbed = program[seed]
    want = reference(config(seed))
    assert img.mean() > 0.05 and perturbed
    limits = registry.cell(CELL)["limits"]
    got = render_entry.compare(img, want)
    assert all(v <= limits[k] for k, v in got.items()), got
    torch.testing.assert_close(img, want, rtol=1e-5, atol=1e-6)
    arrays, static = compile_scene(kiss3.build(PD, config(seed)), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    rays = camera_t.sample_ray(arrays, static, torch.rand((64, 2), generator=gen) * 16,
                               torch.rand((64, 2), generator=gen))
    pinhole = arrays.cam_to_world[:3, 3]
    assert (rays.o - pinhole).norm(dim=-1).max() > 0.01


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_matches_with_images_drawn_from_a_seed(seed, monkeypatch):
    """The same with the checker and the bump replaced by texels drawn from
    the seed, for the program and for the reference alike."""
    monkeypatch.setattr(kiss3, "_image", seeded_images(seed))
    img, perturbed = program_image(config(seed))
    monkeypatch.setattr(kiss3, "_image", seeded_images(seed))
    want = reference(config(seed))
    limits = registry.cell(CELL)["limits"]
    got = render_entry.compare(img, want)
    assert all(v <= limits[k] for k, v in got.items()), got
    torch.testing.assert_close(img, want, rtol=1e-5, atol=1e-6)
    assert img.mean() > 0.05 and perturbed


@pytest.mark.parametrize("feature", ["normal_map", "thin_lens", "base_texture"])
def test_the_comparison_sees_each_feature(program, feature):
    """The reference with the normal map, the thin lens or the base colour's
    image taken out of its scene alone misses the port's image at that
    tolerance."""
    seed = SEEDS[0]
    cfg = copy.deepcopy(config(seed))
    if feature == "normal_map":
        del cfg["spheres"][1]["bsdf"]["normal_map"]
    elif feature == "thin_lens":
        del cfg["thin_lens"]
    else:
        cfg["spheres"][0]["bsdf"]["base_color"] = [0.5, 0.5, 0.5]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(program[seed][0], reference(cfg), rtol=1e-5, atol=1e-6)


def test_the_control_fails_the_limits_and_the_program_passes():
    cell = registry.cell(CELL)
    r = control.readings(cell, 2718281828, True, "cpu", *SMALL)
    assert all(v <= cell["limits"][k] for k, v in r["program"].items()), r
    assert any(v > cell["limits"][k] for k, v in r["control"].items()), r


@pytest.mark.parametrize("fault", ("none",) + faults.ENTRY_FAULTS["render"])
def test_a_broken_timed_path_is_not_correct(fault):
    """A run of the cell at a small size, with one of the render entry's
    faults planted in the program underneath the window: ``correct`` comes
    out false."""
    ctx = faults.planted("render", fault) if fault != "none" else contextlib.nullcontext()
    with ctx:
        res = harness.run_cell(CELL, 1618033988, 0.0, False, "cpu", time.perf_counter(), *SMALL)
    assert res["correct"] is (fault == "none"), res["checks"]
    assert (res["failed"] == 0) is (fault == "none")


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    return shade_host.build(tmp_path_factory.mktemp("shade_host"))


def test_the_traced_window_captures_the_shade_kernels_launches(host_library, monkeypatch):
    """The kernel's source built for the host in the card's library's
    place: a traced window of the cell captures the launches of its traced
    passes, one a bounce, each with its bytes bound; the outputs still pass
    the check; ``shade_cuda`` is the program's own again afterwards."""
    shade_host.kernel_on_host(monkeypatch, host_library)
    cfg, traffic = SMALL
    cell = registry.cell(CELL)
    config_ = dict(registry.config(cell["config"]), **cfg)
    traffic_ = dict(registry.traffic(cell["traffic"]), **traffic)
    job = con1_entry.setup(config_, traffic_, 4000000007, torch.device("cpu"))
    launch = bounce_kernel.shade_cuda
    con1_entry.window(job, 0.0, True)
    assert bounce_kernel.shade_cuda is launch
    got = job.records.launches["K7"]
    assert len(got) == traffic_["trace_passes"] * job.static.max_depth
    lanes = cfg["width"] * cfg["height"]
    table = shade_roofline.table_bytes(job.arrays.shade_tables, job.arrays.textures.texels)
    for k, x in enumerate(got):
        rr = k % job.static.max_depth >= 3
        # the kernel derives the footprint itself: no footprint column read
        want = lanes * shade_roofline.lane_bytes(1, rr, 0) + table
        assert x["n"] == lanes and x["bytes"] == want
        assert x["bound_s"] == pytest.approx(want / 3.35e12)
    assert job.records.extra["shade_kernel_name"] == "shade_kernel"
    readings, failed = con1_entry.check(job, registry.cell(CELL)["limits"])
    assert failed == 0 and readings["mismatch_share"] == 0.0, readings


def test_the_shade_kernel_bytes_by_hand():
    """A lane reads 31 rows, 15 floats of state, 2 flags, its uniforms and
    footprint, and writes 24 floats and two int64; a launch adds its tables
    and texels once."""
    assert shade_roofline.lane_bytes(1, True, 3) == 4 * (31 + 15 + 8 + 3) + 2 + 96 + 16 == 342
    assert shade_roofline.lane_bytes(0, False, 0) == 4 * (31 + 15 + 3) + 2 + 96 + 16 == 310
    assert shade_roofline.lane_bytes(1, False, 1) == 4 * (31 + 15 + 7 + 1) + 2 + 96 + 16

    Tab = dataclasses.make_dataclass("Tab", [("a", object), ("b", object), ("maxlf", int)])
    tab = Tab(torch.zeros((4, 16)), torch.zeros((2, 3), dtype=torch.int64), 3)
    texels = torch.zeros((10, 3))
    assert shade_roofline.table_bytes(tab, texels) == 4 * 64 + 8 * 6 + 4 * 30
    draws = bounce_kernel.Draws(None, *(torch.zeros(100),) * 4, torch.zeros(100),
                                torch.zeros((100, 2)))
    static = type("S", (), {"num_lights": 1})()
    args = (tab, static, None, torch.zeros((100, 3))) + (None,) * 8 + (draws,)
    got = shade_roofline.launch(args, {"texels": texels,
                                       "footprint": (torch.zeros(100), None)})
    want = 100 * shade_roofline.lane_bytes(1, False, 1) + 4 * 64 + 8 * 6 + 4 * 30
    assert got == {"n": 100, "bytes": want, "bound_s": pytest.approx(want / 3.35e12)}


def test_the_shade_kernel_roofline_reader_on_a_recorded_window():
    """The launches' bounds over the shade kernel's device time, in
    percent; nothing to read (None) without a launch or without its
    activities (the plain route, the CPU)."""
    read = registry.metric("shade_kernel_roofline").read
    acts = [Activity("void (anonymous namespace)::shade_kernel<true, true>(Params)", 0, 4000,
                     "shading"),
            Activity("elementwise_kernel", 4000, 1000, "shading"),
            Activity("void (anonymous namespace)::shade_kernel<true, true>(Params)", 6000, 6000,
                     "shading")]
    rec = Records(units=2, window_s=1e-5, busy_s=1.1e-5, activities=acts,
                  launches={"K7": [{"bound_s": 1e-6}, {"bound_s": 2e-6}]},
                  extra={"shade_kernel_name": "shade_kernel"})
    assert read(rec) == pytest.approx(100 * 3e-6 / 1e-5)
    rec.launches = {}
    assert read(rec) is None
    rec.launches = {"K7": [{"bound_s": 1e-6}]}
    rec.activities = acts[1:2]
    assert read(rec) is None


def test_a_run_loads_no_forbidden_module():
    code = (
        "import json, sys, time, torch; torch.set_num_threads(1); t0 = time.perf_counter()\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from kzbench import harness\n"
        f"harness.run_cell({CELL!r}, 3, 0.0, False, 'cpu', t0, {SMALL[0]!r}, {SMALL[1]!r})\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_the_tracer_on_config_3(route, host_library, monkeypatch):
    """Off, the tracer records nothing. On, a pass of config 3 on the CPU
    takes the plain route on its 5 bounces (``shade_plain_reason`` "CPU
    tensors") and looks the base colour and the normal map up as images,
    its _texture_footprint counted ``plain`` once a bounce; with the
    kernel's source built for the host, the kernel route on all 5, each
    bounce counting one ``kernel`` lookup of those two fields and one
    ``kernel`` footprint, and no plain footprint."""
    if route == "kernel":
        shade_host.kernel_on_host(monkeypatch, host_library)
    arrays, static = compile_scene(kiss3.build(PD, config(5, 8, 8, sample_count=1)),
                                   device="cpu")
    metrics.collect()
    render_t.render(arrays, static, device="cpu")
    assert metrics.collect()["shade_plain_reason"] == {}
    with metrics.tracing():
        render_t.render(arrays, static, device="cpu")
    got = metrics.collect()
    lookups = got["texture_lookups"]
    if route == "plain":
        assert got["shade_route"] == {"plain": 5}
        assert got["shade_plain_reason"] == {"CPU tensors": 5}
        assert lookups["base"]["image"] > 0 and lookups["normal"]["image"] == 5
        assert "kernel" not in lookups["base"]
        assert got["texture_footprint"] == {"plain": 5}
    else:
        assert got["shade_route"] == {"kernel": 5} and got["shade_plain_reason"] == {}
        assert {f: r.get("kernel", 0) for f, r in lookups.items()} == {"base": 5, "normal": 5}
        assert lookups["base"]["image"] == 0
        assert got["texture_footprint"] == {"kernel": 5}
