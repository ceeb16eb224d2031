"""The Textured cell (``textured.render_2160p``): discovery by name, the
reference against the program's plain path, the control failing the cell's
limits, and runs with the timed path broken underneath (the render entry's
faults, a Beckmann lobe's alpha, the environment's pdf) coming out not
correct, on the CPU at a small size; on the card, a traced run of the
published frame. The port's CPU tests of the configuration are
``tests/test_torch_textured.py``."""
import contextlib
import json
import time

import pytest
import torch

from kzbench import control, faults, faults_textured, harness, registry, run
from kzbench.reference import render_textured as ref
from kzbench.scenes import textured

CELL = "textured.render_2160p"


def small_config(width=16, height=12, spp=2):
    """The configuration at a size a test run holds: the frame, a 48x24
    sphere, 32-texel images and a 64x32 sky (its sun where the published
    one lies)."""
    cfg = registry.config("textured")
    return dict(width=width, height=height, sample_count=spp, spp=spp,
                sphere=dict(cfg["sphere"], nu=48, nv=24, image_size=32), normal_map_size=32,
                sky=dict(cfg["sky"], height=32, width=64, sun_rows=[8, 10], sun_cols=[20, 23]))


SMALL = (small_config(), {"check_pixels": 16 * 12})


def test_the_cell_is_found_by_name():
    cell = registry.cell(CELL)
    assert cell["config"] == "textured" and cell["chips"] == 1
    assert registry.traffic(cell["traffic"])["entry"] == "render_textured"
    assert registry.entry("render_textured").window
    assert registry.scene(registry.config("textured")["scene"]) is textured
    assert "env_nee_kernel_share" in cell["per_layer"]
    assert registry.metric("env_nee_kernel_share").MOVES in cell["end_to_end"]


def test_reference_matches_the_programs_plain_path():
    """16x16, two passes: the reference at every pixel against the port's
    render() on the CPU (its plain versions of the kernels)."""
    from kazen_tpu_torch.integrate.render import render
    from kazen_tpu_torch.scene import description as PD
    from kazen_tpu_torch.scene.compiler import compile_scene

    cfg = dict(registry.config("textured"), **small_config(16, 16), seed=3000000019)
    arrays, static = compile_scene(textured.build(PD, cfg), device="cpu")
    assert static.env_importance and static.rfilter_kind == "gaussian"
    img = render(arrays, static, spp=2, device="cpu").reshape(-1, 3)
    scene, rstatic = ref.compile_reference(textured.build, cfg, torch.device("cpu"))
    ys, xs = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    want = ref.pixel_values(scene, rstatic, torch.stack([xs.reshape(-1), ys.reshape(-1)], 1), 2)
    assert img.mean() > 0.05
    torch.testing.assert_close(img, want, rtol=1e-5, atol=1e-6)


def test_the_control_fails_the_limits_and_the_program_passes():
    limits = registry.cell(CELL)["limits"]
    r = control.readings(CELL, 2718281828, True, "cpu", *SMALL)
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


@pytest.mark.parametrize("fault", ("none",) + faults.ENTRY_FAULTS["render"]
                         + faults_textured.FAULTS)
def test_a_broken_timed_path_is_not_correct(fault):
    """A run on the CPU at a small size, with ``fault`` planted in the
    program underneath the window: ``correct`` comes out false."""
    if fault in faults_textured.FAULTS:
        ctx = faults_textured.planted(fault)
    else:
        ctx = faults.planted("render", fault) if fault != "none" else contextlib.nullcontext()
    with ctx:
        res = harness.run_cell(CELL, 1618033988, 0.0, False, "cpu", time.perf_counter(), *SMALL)
    assert res["correct"] is (fault == "none"), res["checks"]


@pytest.mark.cuda
def test_a_traced_run_of_the_textured_cell_on_the_card(card, capsys):
    """One call of the published frame (3840x2160, 16 passes) in the window,
    correct against the reference; every bounce's environment NEE on the
    shade kernel, whose traced launches read a share of its roofline."""
    assert run.main(["--workload", CELL, "--seed", "4000000007", "--seconds", "1",
                     "--trace", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["checks"]["route_faults"]["value"] == 0
    assert res["metrics"]["env_nee_kernel_share"]["value"] == 100.0
    assert 0 < res["metrics"]["shade_kernel_roofline"]["value"] <= 100
