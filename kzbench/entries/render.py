"""The ``render`` entry: whole frames through ``render()``, as the CLI calls
it (``render(arrays, static, spp=..., device=...)``: no sampler spec and no
metrics given, so each call builds its own sampler tables).

Set-up compiles the configuration's scene and runs one warm-up call of one
pass, which builds the trace kernels on a fresh checkout and touches every
shape of the frame. The window runs calls back to back until ``seconds``
have passed; the call in progress finishes, and a synchronize ends the
window. ``pixel_samples_per_s`` is the frame's pixels times the passes of
every call over the window's wall time.

The check holds a sample of pixels, drawn from the seed, of every call's
image against the reference (``reference/render.py``) at the same seed and
passes: the share of sampled pixels off by more than 1e-4 + 1e-3 |ref| in
some channel (``mismatch_share``), and the relative gap of the sample's
channel means (``mean_gap``). ``route_faults`` counts megakernel launches
and passes without a trace-kernel launch (the frame must take the
wavefront).

With ``trace`` the first ``trace_passes`` passes of the first call run
under the profiler with the spans below, and every K1/K2 launch in them is
captured for the trace kernels' bound.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .. import harness, profile, registry, roofline

RTOL, ATOL = 1e-3, 1e-4
# spans of the traced window: (module of kazen_tpu_torch, function, stage).
# The program looks each function up by the module attribute at call time.
SPANS = (
    ("samplers.streams", "init_stream_jump", "sampler draws"),
    ("samplers.streams", "next_1d", "sampler draws"),
    ("samplers.streams", "next_2d", "sampler draws"),
    ("samplers.streams", "next_pixel_2d", "sampler draws"),
    ("integrate.path_mis", "_bounce_ordered", "shading"),
    ("integrate.path_mis", "_shade_prologue", "shading"),
    ("integrate.path_mis", "_trace_rows", "trace kernels"),
    ("integrate.path_mis", "_occluded", "trace kernels"),
    ("integrate.path_mis", "packet_key", "ordered permute"),
    ("integrate.path_mis", "_packet_permute", "ordered permute"),
    ("integrate.camera", "sample_ray", "camera"),
    ("film.film", "splat_grid", "splat"),
)
TRACE_KERNELS = {"K1": "nearest_kernel", "K2": "any_hit_kernel"}


@dataclass
class Job:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    arrays: object
    static: object
    spp: int
    lanes: int
    images: list = field(default_factory=list)
    rays: list = field(default_factory=list)
    window_t0: float = 0.0
    window_s: float = 0.0
    records: object = None
    counts: dict = field(default_factory=dict)


def _program():
    import importlib

    return {m: importlib.import_module(f"kazen_tpu_torch.{m}") for m in (
        "integrate.render", "integrate.path_mis", "integrate.camera", "integrate.megakernel",
        "samplers.streams", "film.film", "accel.cluster_trace", "scene.compiler",
        "scene.description")}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(config: dict, traffic: dict, seed: int, device: torch.device) -> Job:
    """Compile the scene and warm up: one render() call of one pass."""
    p = _program()
    build = registry.scene(config["scene"]).build
    cfg = dict(config, seed=seed)
    arrays, static = p["scene.compiler"].compile_scene(build(p["scene.description"], cfg),
                                                       device=device)
    p["integrate.render"].render(arrays, static, spp=1, device=device)
    _sync(device)
    return Job(config=cfg, traffic=traffic, seed=seed, device=device, arrays=arrays,
               static=static, spp=int(config["spp"]), lanes=static.width * static.height)


def _counters(p) -> dict:
    ct, mk = p["accel.cluster_trace"], p["integrate.megakernel"]
    return {"K1": ct.NEAREST.launches, "K2": ct.ANY_HIT.launches, "K3": mk.MEGAKERNEL.launches}


def window(job: Job, seconds: float, trace: bool) -> None:
    """Render calls back to back for ``seconds`` (the last call finishes)."""
    p = _program()
    render_mod = p["integrate.render"]
    ct = p["accel.cluster_trace"]
    trace_passes = int(job.traffic.get("trace_passes", 2)) if trace else 0
    session, captured, seen = None, {"K1": [], "K2": []}, [0]
    if trace:
        def capture(tag):
            def factory(fn):
                def wrapped(tables, rays, *args, **kwargs):
                    out = fn(tables, rays, *args, **kwargs)
                    captured[tag].append((tables, rays.shape[1], out))
                    return out
                return wrapped
            return factory

        patches = [(p[mod], attr, lambda fn, s=stage: profile.span_wrapper(fn, s))
                   for mod, attr, stage in SPANS]
        patches += [(ct, "trace_cuda", capture("K1")), (ct, "occluded_cuda", capture("K2"))]
        session = profile.Session(job.device, patches)

    render_pass = render_mod._render_pass

    def counted_pass(*args, **kwargs):
        # the pass's ray count stays a device tensor: no sync in the window
        if session is not None and seen[0] == 0:
            session.start()
        film, nrays = render_pass(*args, **kwargs)
        job.rays.append(nrays)
        seen[0] += 1
        if session is not None and seen[0] == trace_passes:
            session.stop()
        return film, nrays

    before = _counters(p)
    render_mod._render_pass = counted_pass
    try:
        _sync(job.device)
        t0 = job.window_t0 = time.perf_counter()
        while True:
            job.images.append(render_mod.render(job.arrays, job.static, spp=job.spp,
                                                device=job.device))
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(job.device)
        job.window_s = time.perf_counter() - t0
    finally:
        render_mod._render_pass = render_pass
    after = _counters(p)
    job.counts = {k: after[k] - before[k] for k in after}
    if session is not None:
        rec = session.records(trace_passes)
        for tag, launches in captured.items():
            rec.launches[tag] = [_launch_bound(tag, *c) for c in launches]
        rec.extra["trace_kernel_names"] = TRACE_KERNELS
        job.records = rec


def _launch_bound(tag, tables, n_rays, out):
    tests = float(out[roofline.TEST_ROW[tag]].double().sum())
    keep = (tables.node_scalars, tables.tri) + ((tables.geo_shade,) if tag == "K1" else ())
    table_bytes = sum(t.numel() * t.element_size() for t in keep)
    seconds, by = roofline.launch_bound_s(tag, n_rays, tests, table_bytes)
    return {"n": n_rays, "tests": tests, "bound_s": seconds, "by": by}


def calls(job: Job) -> int:
    return len(job.images)


def end_to_end(job: Job) -> dict:
    passes = len(job.images) * job.spp
    return {"pixel_samples_per_s": (job.lanes * passes / job.window_s, "pixel-samples/s")}


def notes(job: Job) -> str:
    """A line of what the window did, with the program's ray count."""
    rays = float(torch.stack(job.rays).double().sum()) if job.rays else 0.0
    passes = len(job.rays)
    return (f"{len(job.images)} calls, {passes} passes in {job.window_s:.3f} s; "
            f"{rays / max(passes, 1):.6g} rays a pass, {rays / job.window_s:.6g} rays/s; "
            f"launches K1 {job.counts.get('K1')}, K2 {job.counts.get('K2')}, "
            f"K3 {job.counts.get('K3')}")


def sample_pixels(job: Job) -> torch.Tensor:
    """(K, 2) int64 (x, y) of the checked pixels, drawn from the seed."""
    w, h = job.static.width, job.static.height
    k = min(int(job.traffic.get("check_pixels", 1024)), w * h)
    gen = torch.Generator().manual_seed(job.seed)
    idx = torch.randperm(w * h, generator=gen)[:k]
    return torch.stack([idx % w, idx // w], 1)


def release(job: Job, targets: torch.Tensor) -> torch.Tensor:
    """The sampled pixels of every call's image, (calls, K, 3) on the host;
    the program's scene and images are freed."""
    xs, ys = targets[:, 0].to(job.device), targets[:, 1].to(job.device)
    got = torch.stack([img[ys, xs] for img in job.images]).cpu()
    job.images, job.arrays, job.rays = [], None, []
    if job.device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Per call: the mismatch share and the mean gap of ``got`` (K, 3)
    against ``want``. A pixel that is not finite is a mismatch, and makes
    the mean gap NaN or infinite."""
    err = (got - want).abs()
    mismatch = (~(err <= ATOL + RTOL * want.abs()).all(-1)).double().mean().item()
    mw = want.double().mean(0)
    gap = ((got.double().mean(0) - mw).abs() / mw.abs().clamp(min=1e-12)).max().item()
    return {"mismatch_share": mismatch, "mean_gap": gap}


def outputs(job: Job) -> torch.Tensor:
    """The first call's sampled pixels (the control's readings take one)."""
    return release(job, sample_pixels(job))[0]


def expected(job: Job, precision: str = "float32") -> torch.Tensor:
    """The reference's (K, 3) values at the checked pixels after the call's
    passes, at the same seed."""
    from ..reference import render as ref

    build = registry.scene(job.config["scene"]).build
    scene, static = ref.compile_reference(build, job.config, job.device)
    targets = sample_pixels(job).to(job.device)
    return ref.pixel_values(scene, static, targets, job.spp, precision).cpu()


def check(job: Job, limits: dict):
    """(readings {name: value}, failed calls): every call's sample held
    against the reference; the worst call's readings."""
    got = release(job, sample_pixels(job))
    want = expected(job)
    per_call = [compare(g, want) for g in got]
    passes = got.shape[0] * job.spp
    route = 0
    if job.device.type == "cuda":  # the plain versions on the CPU count no launch
        c = job.counts
        route = c["K3"] + max(0, passes - c["K1"]) + max(0, passes - c["K2"])
    failed = sum(1 for r in per_call if any(harness.misses(r[k], limits[k]) for k in r))
    readings = {k: harness.worst(r[k] for r in per_call) for k in per_call[0]}
    readings["route_faults"] = route
    return readings, failed
