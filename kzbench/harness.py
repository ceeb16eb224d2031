"""One run of one cell: set-up, the measured window, the metrics, and the
check of the window's outputs against the reference.

``run_cell`` is what ``run.py`` calls on the card; the tests call it on
the CPU at a small size, with the window's program path broken underneath,
and see ``correct`` come out false.
"""
from __future__ import annotations

import math
import os
import sys

import torch

from . import profile, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "kazen_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark may not import; ``kazen_tpu_torch`` is not
    ``kazen_tpu``."""
    mods = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in mods} & set(FORBIDDEN))


def misses(value: float, limit: float) -> bool:
    """Whether a reading misses its limit; a NaN reading misses every limit."""
    return not value <= limit


def worst(values) -> float:
    """The largest of some readings, NaN counted as infinite."""
    return max(math.inf if math.isnan(v) else v for v in values)


def set_cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout. The
    program builds its CUDA libraries in ``kazen_tpu_torch/build/``."""
    cache = os.path.join(registry.ROOT, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"  # keep any library that would load flax from it


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             config_overrides: dict = None, traffic_overrides: dict = None,
             log=None) -> dict:
    """The result of one run: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and ``breakdown`` with ``trace``), and
    ``checks`` ({name: {value, limit}}) last. ``t0`` is the process's start
    on the host clock (``time.perf_counter``)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = registry.cell(cell_name)
    config = dict(registry.config(cell["config"]), **(config_overrides or {}))
    traffic = dict(registry.traffic(cell["traffic"]), **(traffic_overrides or {}))
    entry = registry.entry(traffic["entry"])
    layer = registry.metrics_of(cell_name) if trace else []

    job = entry.setup(config, traffic, seed, device)
    entry.window(job, seconds, trace)
    # to the first timed call, less what set-up did for the reference
    setup_s = job.window_t0 - t0 - getattr(job, "untimed_s", 0.0)
    log(f"[kzbench] {cell_name} seed {seed}: set-up {setup_s:.3f} s; {entry.notes(job)}")
    attempted = entry.calls(job)
    if trace:
        rec = job.records
        metrics = {}
        for m in layer:
            value = m.read(rec)
            if value is not None:
                metrics[m.NAME] = {"value": float(value), "unit": m.UNIT}
    else:
        measured = dict(entry.end_to_end(job), setup_s=(setup_s, "s"))
        metrics = {k: {"value": float(v), "unit": u} for k, (v, u) in measured.items()
                   if k in cell["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if device.type == "cuda" else 0}
    out = {"correct": False, "attempted": attempted, "failed": attempted, "metrics": metrics,
           "device": dev}
    if trace:
        dev["busy_s"] = job.records.busy_s
        dev["window_s"] = job.records.window_s
        out["breakdown"] = profile.breakdown(job.records)
        job.records = None

    limits = cell["limits"]
    readings, failed = entry.check(job, limits)
    checks = {k: {"value": float(readings[k]), "limit": float(limits[k])} for k in limits}
    out["failed"] = failed
    out["correct"] = failed == 0 and not any(misses(c["value"], c["limit"])
                                             for c in checks.values())
    out["checks"] = checks
    return out
