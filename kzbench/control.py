"""The readings that set a cell's limits: the program's sound runs over
many seeds, the control (the reference computed with its lane state in
bfloat16, put in the program's place), and the planted faults.

    python3 -m kzbench.control --workload <cell> --seeds 1 2 3 ... [--control-seeds 3]
        [--faults state_unchanged half_the_batch altered] [--json FILE]

For each seed: set-up as a run makes it, the timed path for a window of
one call (or, for a fit, its checked steps and one more), then the check's
readings of its outputs against the float32 reference. For the first
``--control-seeds`` seeds also the control's readings against the same
reference, and the readings of each fault planted in the program
(``faults.py``). One process serves every seed, so the kernels are built
once. This is not part of a run; the benchmark's runs compute neither.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def readings(cell_name: str, seed: int, control: bool, device="cuda", config_overrides=None,
             traffic_overrides=None, faults=()) -> dict:
    """{"seed", "program", "control" (or None), "faults": {name: readings},
    "seconds"}. ``cell_name`` may also be a cell's dict, with its
    ``config`` and ``traffic``: a mix that no cell runs yet."""
    import torch

    from . import faults as faults_mod
    from . import registry

    cell = registry.cell(cell_name) if isinstance(cell_name, str) else cell_name
    config = dict(registry.config(cell["config"]), **(config_overrides or {}))
    traffic = dict(registry.traffic(cell["traffic"]), **(traffic_overrides or {}))
    entry = registry.entry(traffic["entry"])
    device = torch.device(device)

    def program_outputs():
        job = entry.setup(config, traffic, seed, device)
        entry.window(job, 0.0, False)
        return job, entry.outputs(job)

    t0 = time.perf_counter()
    job, got = program_outputs()
    t1 = time.perf_counter()
    want = entry.expected(job, "float32")
    t2 = time.perf_counter()
    out = {"seed": seed, "program": entry.compare(got, want), "control": None, "faults": {},
           "seconds": {"program": t1 - t0, "reference": t2 - t1}}
    if control:
        out["control"] = entry.compare(entry.expected(job, "bfloat16"), want)
        out["seconds"]["control"] = time.perf_counter() - t2
        for fault in faults:
            with faults_mod.planted(traffic["entry"], fault):
                _, bad = program_outputs()
            out["faults"][fault] = entry.compare(bad, want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    from . import harness

    harness.set_cache_dirs()
    rows = []
    for k, seed in enumerate(args.seeds):
        row = readings(args.workload, seed, k < args.control_seeds, faults=args.faults)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    for key in rows[0]["program"]:
        prog = harness.worst(r["program"][key] for r in rows)
        ctl = [r["control"][key] for r in rows if r["control"] is not None]
        line = (f"[kzbench] {args.workload} {key}: program max {prog!r} over {len(rows)} seeds; "
                f"control min {min(ctl) if ctl else None!r} over {len(ctl)} seeds")
        for fault in args.faults:
            vals = [r["faults"][fault][key] for r in rows if fault in r["faults"]]
            line += f"; {fault} min {min(vals) if vals else None!r}"
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
