"""kazen_tpu_torch/lab/glue_lab.py, the port of benchmarks/xla_lab.py, on the
CPU at 4,096 lanes: every row of the original and of the port's own glue
runs, and every alternative equals its plain row (gathers exactly, sums
within 1e-5 relative; glue_lab.main raises otherwise)."""
import pytest
import torch

from kazen_tpu_torch.lab import glue_lab

import torch_port_helpers  # noqa: F401  (the port's tests' torch-thread policy)

ORIGINAL_ROWS = [
    "argsort u32 (stable)", "sort u32 (values)", "permute 1 rows", "permute 8 rows",
    "permute 48 rows", "gather (36378, 24) table by id", "plain gather (8, 24) table",
    "one-hot gather (8, 24) table", "rowwise argsort (4, 288)", "rowwise top128 (4, 288)",
    "50 elementwise where-ops (n, 3)", "per-1024-block min/max (n, 3)",
]


def test_glue_lab_rows_on_cpu(capsys):
    rows = glue_lab.main("cpu", lanes=4096, runs=1)
    names = [r["name"] for r in rows]
    assert names[:len(ORIGINAL_ROWS)] == ORIGINAL_ROWS
    for label in ("1 f32", "7 int64", "24 f32"):
        assert f"row gather, {label} columns" in names
        assert f"index_select, {label} columns" in names
    checked = {r["name"]: r for r in rows if "plain" in r}
    assert set(checked) == {
        "one-hot gather (8, 24) table", "rowwise top128 (4, 288)", "index_select, 1 f32 columns",
        "index_select, 7 int64 columns", "index_select, 24 f32 columns",
        "sort-then-segment sum", "one-hot product sum"}
    assert all(r["ok"] for r in checked.values())
    assert checked["one-hot product sum"]["check"] == "rtol 1e-05"
    assert all(r["ms"] > 0 and r["device_ms"] is None and r["lanes"] == 4096 for r in rows)
    assert capsys.readouterr().out.count("[cpu]") == len(rows)


def test_material_sums_agree_on_float_rows():
    """The three sums by material on rows that are not integers: within
    1e-5 relative of the largest entry."""
    g = torch.Generator().manual_seed(0)
    src = torch.rand((4096, 7), generator=g)
    idx = torch.randint(0, 7, (4096,), generator=g)
    want = glue_lab.index_add(src, idx, 7)
    for fn in (glue_lab.segment_sum, glue_lab.onehot_sum):
        got = fn(src, idx, 7)
        assert ((got - want).abs().max() / want.abs().max()).item() <= glue_lab.SUM_RTOL


def test_glue_lab_lanes_must_fill_blocks():
    with pytest.raises(ValueError, match="multiple of 1024"):
        glue_lab.main("cpu", lanes=1000)
