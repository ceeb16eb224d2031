"""The ``optimize`` entry: inverse rendering through the program's
``optimize(arrays, static, target, param_keys=..., spp_per_step=...,
learning_rate=...)``, with the traffic's parameter groups, step and truth.

Set-up compiles the configuration's scene and has the reference render the
target with the traffic's true values at the configuration's
``target_spp`` (``reference/fit.py``: the benchmark makes it, not the
program; its time, ``untimed_s``, is not set-up). The one ``optimize``
call runs the first ``CHECKED_STEPS`` steps, which the check holds against
the reference, before its window starts. The window then counts steps through
``optimize``'s callback until ``seconds`` have passed, and ends the call by
raising from the callback at the end of a step (``optimize`` reads each
step's loss back, so a step's end is on the device too).
``inverse_step_ms`` is the window over its steps; ``inverse_peak_gib`` is
``torch.cuda.max_memory_allocated`` over the window, after
``reset_peak_memory_stats`` at its start.

The check (CHECKED_STEPS steps, the reference following them on its own
scene from the same target): each step's loss (``loss_gap``: the largest
relative gap); the first gradient of each parameter (leaf) as Adam got it,
worked out from its first moment after one step (exp_avg / (1 - b1)), by
norm (``grad_gap``); each leaf's change after the last checked step, by
norm (``change_gap``). A leaf's gap is |program's norm - reference's| over
the larger of the reference's norm of that leaf and of the median leaf;
leaves whose reference gradient is under a thousandth of the median
leaf's (with a median over the leaves whose gradient is not zero) are not
counted: Adam moves them by round-off alone.
"""
from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass, field

import torch

from .. import harness, profile, registry

CHECKED_STEPS = 3
SPANS = (
    ("diff.inverse", "render_image", "forward"),
)


class _WindowEnd(Exception):
    pass


@dataclass
class Job:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    arrays: object
    static: object
    target: torch.Tensor
    losses: list = field(default_factory=list)
    grad: dict = field(default_factory=dict)
    change: dict = field(default_factory=dict)
    steps: int = 0
    untimed_s: float = 0.0
    window_t0: float = 0.0
    window_s: float = 0.0
    peak: int = 0
    records: object = None


def _program():
    import importlib

    return {m: importlib.import_module(f"kazen_tpu_torch.{m}") for m in (
        "diff.inverse", "scene.compiler", "scene.description")}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def job_config(config: dict, traffic: dict, seed: int) -> dict:
    """The configuration with the seed."""
    return dict(config, seed=seed)


def flat(params: dict) -> dict:
    """A parameter dict by leaf name: ``materials.<field>`` or the group."""
    out = {}
    for group, v in params.items():
        if isinstance(v, dict):
            out.update({f"{group}.{k}": t for k, t in v.items()})
        else:
            out[group] = v
    return out


def setup(config: dict, traffic: dict, seed: int, device: torch.device) -> Job:
    """Compile the scene and make the target; the checked steps run at the
    start of ``window``'s optimize call."""
    from ..reference import fit

    p = _program()
    build = registry.scene(config["scene"]).build
    cfg = job_config(config, traffic, seed)
    # the target's sampler seed is the next one: its noise is not the steps'
    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        target = fit.target_image(build, dict(cfg, seed=seed + 1), device, traffic["truth"],
                                  int(config["target_spp"]))
    _sync(device)
    untimed_s = time.perf_counter() - t0
    arrays, static = p["scene.compiler"].compile_scene(build(p["scene.description"], cfg),
                                                       device=device)
    return Job(config=cfg, traffic=traffic, seed=seed, device=device, arrays=arrays,
               static=static, target=target, untimed_s=untimed_s)


def window(job: Job, seconds: float, trace: bool) -> None:
    """One optimize call: CHECKED_STEPS steps of set-up, then steps until
    ``seconds`` have passed."""
    inv = _program()["diff.inverse"]
    trace_steps = int(job.traffic.get("trace_steps", 2)) if trace else 0
    session = None
    if trace:
        mods = _program()
        patches = [(mods[mod], attr, lambda fn, s=stage: profile.span_wrapper(fn, s))
                   for mod, attr, stage in SPANS]
        patches.append((torch.Tensor, "backward",
                        lambda fn: profile.span_wrapper(fn, "backward")))
        patches.append((torch.optim.Adam, "step",
                        lambda fn: profile.span_wrapper(fn, "optimizer")))
        session = profile.Session(job.device, patches)
    keys = tuple(job.traffic["param_keys"])
    start = {k: v.detach().clone() for k, v in flat(inv.get_params(job.arrays, keys)).items()}
    made = []
    adam = torch.optim.Adam

    def capture(*args, **kwargs):
        made.append(adam(*args, **kwargs))
        return made[-1]

    b1 = 0.9

    def callback(it, loss, params):
        leaves = flat(params)
        if it < CHECKED_STEPS:
            job.losses.append(loss)
            if it == 0:
                state = made[0].state
                job.grad = {k: (state[v]["exp_avg"] / (1.0 - b1)).cpu() if v in state
                            else torch.zeros_like(v).cpu() for k, v in leaves.items()}
            if it == CHECKED_STEPS - 1:
                job.change = {k: (v.detach() - start[k]).cpu() for k, v in leaves.items()}
                _sync(job.device)
                if job.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(job.device)
                job.window_t0 = time.perf_counter()
                if session is not None:
                    session.start()
            return
        job.steps += 1
        if session is not None and job.steps == trace_steps:
            session.stop()
        if time.perf_counter() - job.window_t0 >= seconds:
            _sync(job.device)
            job.window_s = time.perf_counter() - job.window_t0
            raise _WindowEnd

    torch.optim.Adam = capture
    try:
        inv.optimize(job.arrays, job.static, job.target, param_keys=keys, steps=10 ** 9,
                     learning_rate=float(job.traffic["learning_rate"]),
                     spp_per_step=int(job.traffic["spp_per_step"]), callback=callback)
    except _WindowEnd:
        pass
    finally:
        torch.optim.Adam = adam
    if job.device.type == "cuda":
        job.peak = torch.cuda.max_memory_allocated(job.device)
    if session is not None:
        job.records = session.records(trace_steps)


def calls(job: Job) -> int:
    return job.steps


def end_to_end(job: Job) -> dict:
    return {"inverse_step_ms": (1e3 * job.window_s / job.steps, "ms"),
            "inverse_peak_gib": (job.peak / 2 ** 30, "GiB")}


def notes(job: Job) -> str:
    return (f"{job.steps} steps in {job.window_s:.3f} s after {CHECKED_STEPS} checked; "
            f"losses {job.losses}")


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def counted_leaves(ref_grad: dict) -> list:
    """The leaves held to the reference: gradient at least a thousandth of
    the median nonzero leaf's, or not finite."""
    norms = _norms(ref_grad)
    nonzero = [n for n in norms.values() if 0.0 < n < math.inf]
    floor = 1e-3 * statistics.median(nonzero) if nonzero else math.inf
    return sorted(k for k, n in norms.items() if n >= floor or math.isnan(n))


def _leaf_gap(got: dict, want: dict, leaves: list) -> float:
    """The worst leaf's gap of norms; NaN counts as infinite."""
    g, w = _norms(got), _norms(want)
    finite = [w[k] for k in leaves if math.isfinite(w[k])]
    med = statistics.median(finite) if finite else 0.0
    return harness.worst([abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in leaves] or [0.0])


def compare(program: dict, ref: dict) -> dict:
    """The check's readings of the program's checked steps against the
    reference's (each a dict of losses, grad, change)."""
    leaves = counted_leaves(ref["grad"])
    loss_gap = harness.worst(abs(a - b) / max(abs(b), 1e-30)
                             for a, b in zip(program["losses"], ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(program["grad"], ref["grad"], leaves),
            "change_gap": _leaf_gap(program["change"], ref["change"], leaves)}


def outputs(job: Job) -> dict:
    """The program's checked steps; its scene is freed."""
    out = {"losses": job.losses, "grad": job.grad, "change": job.change}
    job.arrays = None
    if job.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def expected(job: Job, precision: str = "float32") -> dict:
    """The reference's checked steps from the same target."""
    from ..reference import fit

    build = registry.scene(job.config["scene"]).build
    t = job.traffic
    return fit.follow(build, job.config, job.target, job.device, tuple(t["param_keys"]),
                      CHECKED_STEPS, float(t["learning_rate"]), int(t["spp_per_step"]), precision)


def check(job: Job, limits: dict):
    """(readings, failed): the checked steps against the reference."""
    got = outputs(job)
    readings = compare(got, expected(job))
    failed = job.steps if any(harness.misses(readings[k], limits[k]) for k in readings) else 0
    return readings, failed
