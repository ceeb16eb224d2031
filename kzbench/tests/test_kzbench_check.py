"""The output check: the reference against the program's plain path, the
control failing the cells' limits, and runs with the timed path broken
underneath coming out not correct. On the CPU, at a size a test run holds."""
import contextlib
import time

import pytest
import torch

from kzbench import control, faults, harness, registry
from kzbench.entries import optimize as fit_entry
from kzbench.entries import render as render_entry
from kzbench.reference import render as ref
from kzbench.scenes import cornell

CELLS = ("con2_pmj02bn.render_1080p",)
SMALL = {
    # (config overrides, traffic overrides): a size a test run holds
    "con2_pmj02bn.render_1080p": ({"width": 16, "height": 12, "spp": 2}, {"check_pixels": 192}),
}
# config 5's material fit, which no cell runs yet (PERF.md, Open questions)
FIT = {"config": "cornell_ggx", "traffic": "fit_4k_share"}
FIT_SMALL = ({"width": 48, "height": 32}, {})


@pytest.mark.parametrize("config", ["con2_pmj02bn", "cornell_ggx"])
def test_reference_matches_the_programs_plain_path(config):
    """16x16, two passes: the reference at every pixel against the port's
    render() on the CPU (its plain versions of the trace kernels)."""
    from kazen_tpu_torch.integrate.render import render
    from kazen_tpu_torch.scene import description as PD
    from kazen_tpu_torch.scene.compiler import compile_scene

    cfg = dict(registry.config(config), width=16, height=16, seed=3000000019)
    arrays, static = compile_scene(cornell.build(PD, cfg), device="cpu")
    img = render(arrays, static, spp=2, device="cpu").reshape(-1, 3)
    scene, rstatic = ref.compile_reference(cornell.build, cfg, torch.device("cpu"))
    ys, xs = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    want = ref.pixel_values(scene, rstatic, torch.stack([xs.reshape(-1), ys.reshape(-1)], 1), 2)
    assert img.mean() > 0.05
    torch.testing.assert_close(img, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits_and_the_program_passes(cell):
    limits = registry.cell(cell)["limits"]
    r = control.readings(cell, 2718281828, True, "cpu", *SMALL[cell])
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


FAULT_CASES = [(cell, fault) for cell in CELLS
               for fault in ("none",) + faults.ENTRY_FAULTS[
                   registry.traffic(registry.cell(cell)["traffic"])["entry"]]]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    """A run on the CPU at a small size, with ``fault`` planted in the
    program underneath the window: ``correct`` comes out false."""
    entry = registry.traffic(registry.cell(cell)["traffic"])["entry"]
    ctx = faults.planted(entry, fault) if fault != "none" else contextlib.nullcontext()
    with ctx:
        res = harness.run_cell(cell, 1618033988, 0.0, False, "cpu", time.perf_counter(),
                               *SMALL[cell])
    assert res["correct"] is (fault == "none"), res["checks"]
    assert (res["failed"] == 0) is (fault == "none")


class _Clock:
    """A host clock that moves one second a reading: the window's loop
    runs exactly two render() calls of ``seconds`` 1.5."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


@pytest.mark.parametrize("where", ["image", "pixel"])
def test_a_nan_in_a_later_call_is_not_correct(monkeypatch, where):
    """The second call's image NaN everywhere (``image``), or at one checked
    pixel, which alone is under the mismatch share's limit (``pixel``):
    ``correct`` comes out false and the NaN reading is printed as such."""
    import kazen_tpu_torch.integrate.render as render_mod

    orig, n = render_mod.render, [0]

    def render(*args, **kwargs):
        img = orig(*args, **kwargs)
        n[0] += 1
        if n[0] == 3:  # set-up's warm-up call, then the window's two
            img = img.clone()
            if where == "image":
                img[:] = float("nan")
            else:
                img[0, 0, 1] = float("nan")
        return img

    monkeypatch.setattr(render_mod, "render", render)
    monkeypatch.setattr(render_entry, "time", _Clock())
    cell = "con2_pmj02bn.render_1080p"
    res = harness.run_cell(cell, 1618033988, 1.5, False, "cpu", 0.0, *SMALL[cell])
    assert res["attempted"] == 2 and res["failed"] == 1
    assert res["correct"] is False
    assert res["checks"]["mean_gap"]["value"] == float("inf")
    if where == "image":
        assert res["checks"]["mismatch_share"]["value"] == 1.0


def test_the_fit_reference_follows_the_programs_plain_path():
    """Config 5's material fit: the reference's first fit steps against the
    port's optimize on the CPU (each step's loss, the first gradient and the
    change of every parameter); the control and each planted fault read at
    least ten times the program's bound."""
    res = control.readings(FIT, 3000000019, True, "cpu", *FIT_SMALL,
                           faults=faults.ENTRY_FAULTS["optimize"])
    assert all(v < 1e-5 for v in res["program"].values()), res
    assert max(res["control"].values()) > 1e-4, res
    for fault, r in res["faults"].items():
        assert max(r.values()) > 1e-4, (fault, r)


def test_a_nan_in_the_third_fit_step_fails_any_limit(monkeypatch):
    """A NaN loss in the last checked step: every reading it reaches is
    infinite, so it fails even limits of 1."""
    import kazen_tpu_torch.diff.inverse as inv

    orig, n = inv.image_loss, [0]

    def image_loss(img, target):
        n[0] += 1
        loss = orig(img, target)
        return loss * float("nan") if n[0] == fit_entry.CHECKED_STEPS else loss

    monkeypatch.setattr(inv, "image_loss", image_loss)
    config = dict(registry.config(FIT["config"]), **FIT_SMALL[0])
    traffic = registry.traffic(FIT["traffic"])
    job = fit_entry.setup(config, traffic, 1618033988, torch.device("cpu"))
    fit_entry.window(job, 0.0, False)
    assert job.losses[0] == job.losses[0] and job.losses[-1] != job.losses[-1]
    limits = {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}
    readings, failed = fit_entry.check(job, limits)
    assert failed == job.steps > 0
    assert readings["loss_gap"] == float("inf") and readings["change_gap"] == float("inf")
    assert any(harness.misses(readings[k], limits[k]) for k in limits)
