"""The config 3 cell on the card: a short run prints a correct result with
every bounce on the shade kernel, and runs at a reduced size with the
render entry's faults planted underneath the window come out not correct.
The CPU tests of the cell are ``tests/test_torch_kiss3.py``."""
import contextlib
import json
import time

import pytest

from kzbench import faults, harness, run

CELL = "kiss3.render_2160p_thinlens"
REDUCED = ({"width": 512, "height": 512, "spp": 4}, {"check_pixels": 1024})


@pytest.mark.cuda
def test_a_traced_run_of_the_kiss3_cell_on_the_card(card, capsys):
    """One call of the published frame (3840x2160, 64 passes) in the window,
    correct against the reference; the traced passes' shade kernel reads a
    share of its roofline."""
    assert run.main(["--workload", CELL, "--seed", "4000000007", "--seconds", "1",
                     "--trace", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["checks"]["route_faults"]["value"] == 0
    assert 0 < res["metrics"]["shade_kernel_roofline"]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ("none",) + faults.ENTRY_FAULTS["render"])
def test_a_broken_timed_path_on_the_card_is_not_correct(card, fault):
    ctx = faults.planted("render", fault) if fault != "none" else contextlib.nullcontext()
    with ctx:
        res = harness.run_cell(CELL, 2147483659, 0.0, False, "cuda", time.perf_counter(),
                               *REDUCED)
    assert res["correct"] is (fault == "none"), res["checks"]
