"""The Textured configuration (kazen-con-1's whole pipeline: Beckmann rough
conductor, plastic and dielectric under an importance-sampled sky with a
sun, an image-textured kiss, a normal-mapped floor) as the benchmark runs
it, on the CPU at a small size: the scene and its route through the port,
its reference (``kzbench/reference/render_textured.py``) against the
port's render() at 24x24 and its eye for each mechanism, the shade
kernel's launches and the program's counters as the traced window
captures them (the kernel's source built for the host), and the reader of
``env_nee_kernel_share``."""
import dataclasses

import numpy as np
import pytest
import torch

from kazen_tpu_torch.integrate import megakernel as mk
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.scene import description as PD
from kazen_tpu_torch.scene.compiler import (
    BSDF_ROUGHCONDUCTOR,
    BSDF_ROUGHDIELECTRIC,
    BSDF_ROUGHPLASTIC,
    compile_numpy,
    compile_scene,
)
from kazen_tpu_torch.shade import bounce_kernel
from kzbench import registry, shade_roofline
from kzbench.entries import render as render_entry
from kzbench.entries import render_textured as entry
from kzbench.profile import Records
from kzbench.reference import render_textured as ref
from kzbench.scenes import textured

import shade_host
import torch_port_helpers

CELL = "textured.render_2160p"
W = H = 24
SEED = 3000000019


def config(seed=SEED, width=W, height=H, spp=2, **changes):
    """The configuration at a size the CPU holds: a 48x24 sphere, 32-texel
    images and a 64x32 sky with its sun where the published one lies."""
    cfg = registry.config("textured")
    return dict(cfg, width=width, height=height, sample_count=spp, spp=spp, seed=seed,
                sphere=dict(cfg["sphere"], nu=48, nv=24, image_size=32), normal_map_size=32,
                sky=dict(cfg["sky"], height=32, width=64, sun_rows=[8, 10], sun_cols=[20, 23]),
                **changes)


def pixels(width=W, height=H):
    ys, xs = torch.meshgrid(torch.arange(height), torch.arange(width), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], 1)


def reference(cfg, build=textured.build, every=1):
    """The reference at every ``every``-th pixel of the frame."""
    scene, static = ref.compile_reference(build, cfg, torch.device("cpu"))
    return ref.pixel_values(scene, static, pixels(cfg["width"], cfg["height"])[::every],
                            cfg["spp"])


@pytest.fixture(scope="module")
def program():
    cfg = config()
    arrays, static = compile_scene(textured.build(PD, cfg), device="cpu")
    return render_t.render(arrays, static, spp=cfg["spp"], device="cpu").reshape(-1, 3)


def test_the_scene_is_the_stand_in():
    """The benchmark's builder at the configuration's published numbers:
    36,882 faces (a 36,864-face sphere), the three rough* lobes, kiss and
    the normal map, an importance-sampled 512x256 sky, the gaussian filter,
    pmj02bn at 3840x2160."""
    cfg = dict(registry.config("textured"), seed=1)
    arrays, static = compile_numpy(textured.build(PD, cfg))
    assert len(arrays["F"]) == cfg["faces"] == 36882
    assert set(static["btypes_present"]) >= {BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC,
                                             BSDF_ROUGHDIELECTRIC}
    assert static["env_importance"] and static["rfilter_kind"] == "gaussian"
    assert static["sampler_kind"] == "pmj02bn" and (static["width"], static["height"]) == (
        3840, 2160)
    tex = arrays["textures"]
    assert sorted(zip(tex["width"].tolist(), tex["height"].tolist())) == [
        (512, 256), (512, 512), (1024, 1024), (1024, 1024)]


def test_the_scene_takes_the_wavefront_and_the_shade_kernel():
    """36.9k faces put the scene outside the megakernel's class; the rough*
    lobes, the image-textured base colour and roughness, the normal map and
    the importance-sampled sky are in the shade kernel's. The helpers'
    Textured box with composite texture nodes over textured fields keeps
    the plain route, with its reason."""
    arrays, static = compile_scene(textured.build(PD, config()), device="cpu")
    assert not static.use_megakernel and not mk.supported_reason(arrays, static)[0]
    assert static.textured_fields == ("base", "roughness", "normal")
    assert bounce_kernel.env_nee(static) and bounce_kernel.rough_lobes(static)
    assert bounce_kernel.supported_reason(arrays, static) == (True, "supported")
    desc = torch_port_helpers.to_port(torch_port_helpers.textured_scene(8, 8, composite=True))
    arrays, static = compile_scene(desc, device="cpu")
    assert bounce_kernel.supported_reason(arrays, static) == (
        False, "composite texture nodes with textured material fields")


def test_reference_matches_the_programs_plain_path(program):
    """24x24, two passes, images and sky drawn from the seed: the reference
    at every pixel against the port's render() on the CPU, within the
    cell's limits and at the tolerance con-2's reference is held to."""
    want = reference(config())
    assert program.mean() > 0.05
    limits = registry.cell(CELL)["limits"]
    got = render_entry.compare(program, want)
    assert all(v <= limits[k] for k, v in got.items()), got
    torch.testing.assert_close(program, want, rtol=1e-5, atol=1e-6)


def _no_importance(D, cfg):
    desc = textured.build(D, cfg)
    desc.background.importance = False
    return desc


def _smooth_lobes(D, cfg):
    desc = textured.build(D, cfg)
    for mesh in desc.meshes[-3:]:
        field = "alpha" if hasattr(mesh.bsdf, "alpha") else "roughness"
        mesh.bsdf = dataclasses.replace(mesh.bsdf, **{field: 0.35})
    return desc


@pytest.mark.parametrize("feature", ["env_importance", "beckmann_alpha", "gaussian_filter"])
def test_the_comparison_sees_each_mechanism(program, feature):
    """The reference without the environment's NEE stratum, with the rough*
    lobes' roughness changed, or with the box filter in the gaussian's
    place misses the port's image at that tolerance (every 4th pixel)."""
    cfg = config()
    build = {"env_importance": _no_importance, "beckmann_alpha": _smooth_lobes}.get(
        feature, textured.build)
    if feature == "gaussian_filter":
        cfg["rfilter"] = "box"
    with pytest.raises(AssertionError):
        torch.testing.assert_close(program[::4], reference(cfg, build, 4), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    return shade_host.build(tmp_path_factory.mktemp("shade_host"))


def test_the_traced_window_captures_the_kernel_and_the_counters(host_library, monkeypatch):
    """The kernel's source built for the host in the card's library's
    place: a traced window of the cell captures the launches of its traced
    passes, one a bounce, each with its bytes bound (the environment's and
    the rough* lobes' tables counted once a launch); the 1-pass call after
    the window counts every bounce's environment NEE and Beckmann lobes on
    the kernel, so ``env_nee_kernel_share`` reads 100; the outputs still
    pass the check."""
    shade_host.kernel_on_host(monkeypatch, host_library)
    cell = registry.cell(CELL)
    cfg = dict(config(spp=2, width=16, height=12), seed=4000000007)
    traffic = dict(registry.traffic(cell["traffic"]), check_pixels=16 * 12)
    job = entry.setup(cfg, traffic, 4000000007, torch.device("cpu"))
    launch = bounce_kernel.shade_cuda
    entry.window(job, 0.0, True)
    assert bounce_kernel.shade_cuda is launch
    depth = job.static.max_depth
    got = job.records.launches["K7"]
    assert len(got) == traffic["trace_passes"] * depth
    tables = job.arrays.shade_tables
    table = shade_roofline.table_bytes(tables, job.arrays.textures.texels)
    assert table >= 4 * (tables.env_row.numel() + tables.env_col.numel()
                         + tables.env_pdf.numel() + tables.beck.numel())
    for k, x in enumerate(got):
        want = 16 * 12 * shade_roofline.lane_bytes(1, k % depth >= 3, 0) + table
        assert x["bytes"] == want
    counters = job.records.extra["counters"]
    assert counters["env_nee"] == {"kernel": depth} == counters["beckmann_lobes"]
    assert counters["shade_route"] == {"kernel": depth}
    assert registry.metric("env_nee_kernel_share").read(job.records) == 100.0
    readings, failed = entry.check(job, cell["limits"])
    assert failed == 0 and readings["mismatch_share"] == 0.0, readings


def test_the_env_nee_kernel_share_reader():
    """``kernel`` over every route, in percent; nothing to read (None)
    where the program counted nothing, as a program without the counter."""
    read = registry.metric("env_nee_kernel_share").read
    rec = Records(units=2, window_s=1.0, busy_s=0.5, activities=[])
    assert read(rec) is None
    rec.extra["counters"] = {"shade_route": {"plain": 5}}
    assert read(rec) is None
    rec.extra["counters"] = {"env_nee": {"kernel": 3, "plain": 1}}
    assert read(rec) == 75.0
    rec.extra["counters"] = {"env_nee": {"plain": 5}}
    assert read(rec) == 0.0
    assert np.isclose(read(Records(1, 1.0, 1.0, [], extra={"counters": {
        "env_nee": {"kernel": 5}}})), 100.0)
