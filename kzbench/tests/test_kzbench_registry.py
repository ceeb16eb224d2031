"""Discovery by name, BENCHMARK.json against the files it names, the shape
of a run's result line, and the import rules."""
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from kzbench import harness, registry, run

ROOT = os.path.dirname(registry.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_names_what_the_harness_finds():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["kzbench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        cfg = registry.config(c["name"])
        assert c["file"] == f"kzbench/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"]
        assert c["source"] == cfg["source"]
        assert registry.scene(cfg["scene"]).build
    for w in b["workloads"]:
        cell = registry.cell(w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell["config"], cell["traffic"], cell["chips"], cell["why"])
        assert registry.entry(registry.traffic(w["traffic"])["entry"]).window
        assert set(cell["end_to_end"]) <= {m["name"] for m in b["end_to_end"]}
        assert "setup_s" in cell["end_to_end"]
        assert cell["per_layer"] and set(cell["per_layer"]) <= {m["name"] for m in b["per_layer"]}
    assert sorted(w["name"] for w in b["workloads"]) == registry.names("cells")
    assert {m["name"] for m in b["per_layer"]} <= set(registry.metric_names())
    for m in b["per_layer"]:
        r = registry.metric(m["name"])
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            r.UNIT, r.BETTER, r.SOURCE, r.LAYER, r.MOVES)
        assert m["workloads"] == [w["name"] for w in b["workloads"]
                                  if m["name"] in registry.cell(w["name"])["per_layer"]]
        for cell in m["workloads"]:
            assert m["moves"] in registry.cell(cell)["end_to_end"]


def test_benchmark_json_keeps_to_its_format_limits():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_cell_and_metric_are_found_without_editing_a_file(tmp_path, tiny):
    """A copy of kzbench with one cell, one configuration and one metric
    added as new files: the harness finds and runs them."""
    copy = tmp_path / "kzbench"
    shutil.copytree(registry.ROOT, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: open(p, "rb").read() for p in
              (os.path.join(dp, f) for dp, _, fs in os.walk(copy) for f in fs)}
    cfg = json.load(open(copy / "configs" / "con2_pmj02bn.json"))
    cfg.update(tiny[0])
    (copy / "configs" / "dummy_tiny.json").write_text(json.dumps(cfg))
    (copy / "cells" / "dummy_tiny.frames.json").write_text(json.dumps({
        "config": "dummy_tiny", "traffic": "frames_back_to_back", "chips": 1,
        "end_to_end": ["pixel_samples_per_s", "setup_s"], "per_layer": ["dummy_units"],
        "why": "a test cell",
        "limits": {"mismatch_share": 0.0, "mean_gap": 1e-6, "route_faults": 0}}))
    (copy / "metrics" / "dummy_units.py").write_text(
        'NAME = "dummy_units"\nUNIT = "passes"\nBETTER = "higher"\nSOURCE = "device_trace"\n'
        'LAYER = "test"\nMOVES = "pixel_samples_per_s"\n\n\n'
        "def read(rec):\n    return rec.units\n")
    for p, data in before.items():
        assert open(p, "rb").read() == data
    code = (
        "import json, sys, time, torch; torch.set_num_threads(2); t0 = time.perf_counter()\n"
        f"sys.path.insert(0, {str(tmp_path)!r}); sys.path.insert(1, {ROOT!r})\n"
        "from kzbench import harness, registry\n"
        f"assert registry.ROOT == {str(copy)!r}\n"
        "assert 'dummy_tiny.frames' in registry.names('cells')\n"
        "res = harness.run_cell('dummy_tiny.frames', 5, 0.0, True, 'cpu', t0,\n"
        "                       traffic_overrides={'check_pixels': 192})\n"
        "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"] == {"dummy_units": {"value": 2.0, "unit": "passes"}}
    assert res["correct"] is True


def test_result_line_shape(tiny):
    res = harness.run_cell("con2_pmj02bn.render_1080p", 4000000007, 0.0, False, "cpu",
                           time.perf_counter(), *tiny)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"pixel_samples_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "con2_pmj02bn.render_1080p", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules({"kazen_tpu_torch": 1, "kazen_tpu_torch.core": 1,
                                      "jaxtyping": 1, "jax_foo": 1}) == []
    assert harness.forbidden_modules({"kazen_tpu.core.rng": 1, "jax": 1, "flax.nn": 1,
                                      "jaxlib": 1}) == ["flax", "jax", "jaxlib", "kazen_tpu"]


def test_a_run_loads_no_forbidden_module(tiny):
    code = (
        "import json, sys, time, torch; torch.set_num_threads(2); t0 = time.perf_counter()\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from kzbench import harness, control\n"
        f"harness.run_cell('con2_pmj02bn.render_1080p', 3, 0.0, True, 'cpu', t0, {tiny[0]!r},"
        f" {tiny[1]!r})\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_nothing_reads_the_jax_benchmarks_or_chip_smoke():
    pat = re.compile(r"\b(import|from)\s+(jax|jaxlib|flax|kazen_tpu|benchmarks|bench|chip_smoke)\b"
                     r"|chip_smoke\.py|bench\.py|benchmarks/")
    here = os.path.abspath(__file__)
    for dp, _, fs in os.walk(registry.ROOT):
        for f in fs:
            path = os.path.join(dp, f)
            if f.endswith(".py") and path != here:
                with open(path) as fh:
                    assert not pat.search(fh.read()), path


@pytest.mark.cuda
def test_a_run_on_the_card(card, capsys):
    """On a machine with a card: one short run of the render cell prints a
    correct result as its last line."""
    assert run.main(["--workload", "con2_pmj02bn.render_1080p", "--seed", "4000000007",
                     "--seconds", "1", "--trace", "0"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
