"""Micro-costs of the PyTorch glue the wavefront leans on: the port of
``benchmarks/xla_lab.py`` (which priced the same operations under XLA on the
TPU).

Every row of the original, at 2,073,600 lanes (a 1920x1080 pass) by
default: the stable argsort the port uses (``torch.argsort(stable=True)``),
a sort of values, permutes of 1, 8 and 48 rows, a (36378, 24) table gathered
by id, an (8, 24) table by plain gather and by one-hot product, a rowwise
argsort and a rowwise top-128 over (lanes / 1024, 288), 50 elementwise
where-ops on (lanes, 3) and per-1024-block min/max. Then the rows the port's
own glue asks about: gathers of 1, 7 (int64) and 24 (f32) lane-major columns
by a permutation (the ordered permute's shape, ``integrate/path_mis.py:
_packet_permute``), and for the inverse step's backward the ``index_add_``
of per-lane 7-column material rows into a 7-row table against a
sort-then-segment sum and a one-hot product.

Each alternative is held to its plain row: gathers equal, sums within 1e-5
relative. The summed material rows are small integers, so every partial sum
is exact in f32 and the three orders of summation must agree: the limit then
checks which lanes went to which row, not the rounding of a 2M-term f32 sum.

Each row gets event ms (the mean of 3 calls after a warm-up) and, on the
card, its device ms and launches under torch.profiler. Inputs come from
numpy's generator seeded ``seed``, drawn in the original's order first.

``python -m kazen_tpu_torch.lab.glue_lab`` runs it on the card;
``--device cpu --lanes 4096`` runs it small on the CPU.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.device import resolve_device
from . import device_name, table_times

LANES = 1920 * 1080
BLOCK = 1024  # lanes a block of the rowwise and per-block rows
TABLE_ROWS = 36378  # faces of the hero scene
MATERIALS = 7  # material rows of the stand-in scene
SUM_RTOL = 1e-5


def onehot_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as a product of the one-hot rows of idx with the table."""
    onehot = (idx[:, None] == torch.arange(table.shape[0], device=idx.device)).to(table.dtype)
    return onehot @ table


def segment_sum(src: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows of src summed by idx: a stable sort by idx, then one sum per
    segment."""
    order = torch.argsort(idx, stable=True)
    lengths = torch.bincount(idx, minlength=rows)
    return torch.segment_reduce(src[order], "sum", lengths=lengths, axis=0)


def onehot_sum(src: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows of src summed by idx as the product of the one-hot columns of
    idx with src."""
    onehot = (idx[None, :] == torch.arange(rows, device=idx.device)[:, None]).to(src.dtype)
    return onehot @ src


def index_add(src: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.zeros((rows, src.shape[1]), dtype=src.dtype, device=src.device).index_add_(
        0, idx, src)


def _inputs(lanes: int, seed: int, dev: torch.device) -> dict:
    rng = np.random.default_rng(seed)
    x = {
        "keys": rng.integers(0, 1 << 30, lanes, dtype=np.int64),
        "order": rng.permutation(lanes),
        "rows1": rng.random((1, lanes), dtype=np.float32),
        "rows8": rng.random((8, lanes), dtype=np.float32),
        "rows48": rng.random((48, lanes), dtype=np.float32),
        "table_big": rng.random((TABLE_ROWS, 24), dtype=np.float32),
        "fid": rng.integers(0, TABLE_ROWS, lanes),
        "table8": rng.random((8, 24), dtype=np.float32),
        "lid": rng.integers(0, 6, lanes),
        "blocks": rng.random((lanes // BLOCK, 288), dtype=np.float32),
        "elem": rng.random((lanes, 3), dtype=np.float32),
        "pts": rng.random((lanes, 3), dtype=np.float32),
        "col1": rng.random(lanes, dtype=np.float32),
        "col7": rng.integers(0, 1 << 40, (lanes, 7), dtype=np.int64),
        "col24": rng.random((lanes, 24), dtype=np.float32),
        "mat_rows": rng.integers(0, 16, (lanes, 7)).astype(np.float32),
        "mat_id": rng.integers(0, MATERIALS, lanes),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}


def main(device="cuda", lanes: int = LANES, seed: int = 0, runs: int = 3) -> list:
    """Run every row at ``lanes`` lanes; print one line each and return the
    rows: name, lanes, ms, device_ms, launches, and for an alternative the
    plain row it is held to, the check and its error."""
    dev = resolve_device(device)
    if lanes <= 0 or lanes % BLOCK:
        raise ValueError(f"lanes must be a positive multiple of {BLOCK}, got {lanes}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated: f32 products
    x = _inputs(lanes, seed, dev)
    order, b = x["order"], x["blocks"]
    src, mid = x["mat_rows"], x["mat_id"]
    add_rows = f"index_add_ (n, 7) into ({MATERIALS}, 7)"
    # (name, fn, the plain row an alternative is held to, what is compared)
    table = [
        ("argsort u32 (stable)", lambda: torch.argsort(x["keys"], stable=True), None, None),
        ("sort u32 (values)", lambda: torch.sort(x["keys"]).values, None, None),
        *((f"permute {x[k].shape[0]} rows", lambda k=k: x[k][:, order], None, None)
          for k in ("rows1", "rows8", "rows48")),
        (f"gather ({TABLE_ROWS}, 24) table by id", lambda: x["table_big"][x["fid"]], None, None),
        ("plain gather (8, 24) table", lambda: x["table8"][x["lid"]], None, None),
        ("one-hot gather (8, 24) table", lambda: onehot_gather(x["table8"], x["lid"]),
         "plain gather (8, 24) table", None),
        (f"rowwise argsort ({b.shape[0]}, 288)", lambda: torch.argsort(b, dim=1), None, None),
        # top-128 against the argsort's first 128: the values they pick (ties
        # may order their indices differently)
        (f"rowwise top128 ({b.shape[0]}, 288)", lambda: torch.topk(-b, 128, dim=1).indices,
         f"rowwise argsort ({b.shape[0]}, 288)", lambda f: b.gather(1, f()[:, :128])),
        ("50 elementwise where-ops (n, 3)", lambda: _elementwise(x["elem"]), None, None),
        ("per-1024-block min/max (n, 3)", lambda: _block_minmax(x["pts"]), None, None),
    ]
    # the ordered permute's shape: lane-major columns gathered by a permutation
    for k, label in (("col1", "1 f32"), ("col7", "7 int64"), ("col24", "24 f32")):
        table += [(f"row gather, {label} columns", lambda k=k: x[k][order], None, None),
                  (f"index_select, {label} columns",
                   lambda k=k: torch.index_select(x[k], 0, order),
                   f"row gather, {label} columns", None)]
    # the backward's material rows into the 7-row table
    table += [(add_rows, lambda: index_add(src, mid, MATERIALS), None, None),
              ("sort-then-segment sum", lambda: segment_sum(src, mid, MATERIALS), add_rows, None),
              ("one-hot product sum", lambda: onehot_sum(src, mid, MATERIALS), add_rows, None)]

    fns = {name: fn for name, fn, _, _ in table}
    rows = table_times([(name, fn) for name, fn, _, _ in table], dev, runs)
    where = device_name(dev)
    for r, (name, fn, plain, compare) in zip(rows, table):
        r["lanes"] = lanes
        if plain is not None:
            pick = compare or (lambda f: f())
            got, want = pick(fn), pick(fns[plain])
            if name.endswith(" sum"):
                err = ((got - want).abs().max() / want.abs().max()).item()
                r.update(plain=plain, check=f"rtol {SUM_RTOL}", err=err, ok=err <= SUM_RTOL)
            else:
                r.update(plain=plain, check="equal", ok=torch.equal(got, want))
            if not r["ok"]:
                raise AssertionError(f"glue_lab: {name} differs from {plain}: {r}")
        dms = "" if r["device_ms"] is None else (
            f", device {r['device_ms']:.4f} ms in {r['launches']} launches")
        chk = f", {r['check']} to {plain}" if plain is not None else ""
        print(f"{name:40s}: {r['ms']:9.4f} ms{dms}{chk} [{where}]", flush=True)
    return rows


def _elementwise(x: torch.Tensor) -> torch.Tensor:
    for _ in range(50):
        x = torch.where(x > 0.5, x * 0.99, x + 0.01)
    return x


def _block_minmax(p: torch.Tensor) -> torch.Tensor:
    b = p.reshape(-1, BLOCK, 3)
    return torch.stack([b.amin(1), b.amax(1)])


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--lanes", type=int, default=LANES)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", help="write the rows to this file")
    args = parser.parse_args()
    table = main(args.device, args.lanes, args.seed)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(table, f, indent=1)
