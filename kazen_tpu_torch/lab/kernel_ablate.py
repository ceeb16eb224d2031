"""K1's cost split between node steps and leaves: the port of
``benchmarks/kernel_ablate.py``.

The original times the TPU's nearest-hit kernel on pre-sorted bounce-1 rays
of the hero scene, reads its visit and step counts, and is run again under
``KAZEN_TRACE_ABLATE=nofetch`` to price the winner's attribute fetch. Here:

* the rays: the hero XML is not in the repository, so the stand-in (the
  Cornell box and a 192 x 96 lat-long kiss sphere, 36,876 faces against the
  hero's 36,378) at the original's 960x540. Bounce-1 rays come from
  ``profile_pass2.bounce1_state``, sorted in the order the ordered
  wavefront gives them (a stable argsort of ``path_mis.packet_key``, lanes
  with nothing to trace last) and packed with ``cluster_trace.pack_rays``;
* the original's rows: K1 (``trace_cuda``) on those rays, ``REPS``
  launches timed with CUDA events, its visits, node steps and triangle
  tests (rows 34-36) per lane and as each warp's maximum (what SIMT pays),
  in the original's columns per 1,024 lanes; the nofetch instance
  (``trace_nofetch_cuda``, a compile-time instance of the same kernel,
  never an environment switch) on the same rays; K2 (``occluded_cuda``) on
  the same rays;
* the split: K1's ms a launch fitted by least squares as intercept + a *
  (sum over warps of the warp's most node steps) + b * (sum over warps of
  its most triangle tests), + c * lanes where that improves the adjusted
  R^2, over the ray sets of ``ray_sets``: the 7 K1 launches of a stand-in
  pass at ``pass_size``, bounce 1 sorted and unsorted at ``size`` and
  ``pass_size``, ``N_RANDOM`` random rays and a frame of camera rays. Each
  set's node-step share is a * S / ms, and the nofetch instance's saving
  the default's ms less its own (timed in turns).

On the CPU the plain walks stand in for the kernels (``trace_walk_plain``,
``trace_nofetch_plain``, ``occluded_walk_plain``) and the host clock for
CUDA events, so the rows and the fit run small there; its times are the
CPU's. ``python -m kazen_tpu_torch.lab.kernel_ablate [--size WxH] [--device
cpu] [--json FILE]`` runs it on the card by default.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..accel import cluster_trace as ct
from ..core.device import card_line, resolve_device
from ..examples.baseline_configs import cornell_box
from ..integrate import path_mis
from ..integrate.render import render, sampler_spec
from ..scene import description as D
from ..scene.compiler import compile_scene
from . import profile_pass2, timed

SPHERE = (192, 96)  # the stand-in sphere's (nu, nv): 2 nu nv = 36,864 faces
N_RANDOM = 262_144
SEED = 7
REPS = 16
WARP = 32
LANES_PER_BLOCK = 1024  # the original's block of lanes


# ---------------------------------------------------------------------------
# the scene and the ray sets
# ---------------------------------------------------------------------------


def lat_long_sphere(center, radius, nu, nv, bsdf):
    """A lat-long sphere of 2 nu nv faces with smooth normals and uvs (the
    layout of tests/scenes.py's sphere_mesh, built without a Python loop)."""
    c = np.asarray(center, np.float32)
    uu, vv = np.meshgrid(np.linspace(0.0, 2.0 * np.pi, nu + 1, dtype=np.float32),
                         np.linspace(0.0, np.pi, nv + 1, dtype=np.float32), indexing="ij")
    normals = np.stack([np.sin(vv) * np.cos(uu), np.cos(vv), np.sin(vv) * np.sin(uu)],
                       -1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu / (2.0 * np.pi), vv / np.pi], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b = ((i + 1) * (nv + 1) + j).reshape(-1)
    cc = b + 1
    d = a + 1
    faces = np.stack([np.stack([a, b, cc], 1), np.stack([a, cc, d], 1)], 1)
    return D.Mesh(vertices=(c + radius * normals).astype(np.float32),
                  faces=faces.reshape(-1, 3).astype(np.int32), normals=normals,
                  uvs=uvs.astype(np.float32), bsdf=bsdf)


def stand_in_scene(width: int, height: int):
    """The Cornell box plus the kiss sphere of SPHERE, 1 spp, depth 5."""
    sphere = lat_long_sphere(
        [0.0, 0.7, 0.2], 0.6, *SPHERE,
        D.KazenStandard(base_color=(0.6, 0.4, 0.8), metallic=0.3, roughness=0.3))
    return cornell_box(width=width, height=height, spp=1, max_depth=5, extra_meshes=[sphere])


def random_rays(n: int, device) -> torch.Tensor:
    """``n`` seeded rays from around (0, 1, -1) in uniform directions,
    packed (8, n): mint 1e-4, maxt 3e38."""
    rng = np.random.RandomState(SEED)
    o = np.array([[0.0, 1.0, -1.0]], np.float32) + 0.5 * rng.randn(n, 3).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)
    return ct.pack_rays(o, d, 1e-4, torch.full((n,), 3.0e38, device=device))


def camera_rays(scene, static, spec) -> torch.Tensor:
    """Sample pass 0's camera rays over the pixel grid, packed."""
    _, rays = profile_pass2.camera_batch(scene, static, spec)
    return ct.pack_rays(rays.o, rays.d, rays.mint, rays.maxt)


def packet_order(b) -> torch.Tensor:
    """The ordered wavefront's lane order after the first shade: a stable
    argsort of the packet key, lanes with nothing to trace last."""
    return torch.argsort(path_mis.packet_key(b.pick, b.cluster, b.d, b.alive, b.shadow_maxt),
                         stable=True)


def bounce1_rays(scene, static, spec, sort: bool = True) -> torch.Tensor:
    """The bounce-1 path rays of sample pass 0, packed (8, N): in the
    packet order (``sort``) or in pixel order; dead lanes have maxt -1."""
    b = profile_pass2.bounce1_state(scene, static, spec)
    p, d = b.p, b.d
    maxt = torch.where(b.alive, path_mis.INF, -1.0)
    if sort:
        order = packet_order(b)
        p, d, maxt = p[order], d[order], maxt[order]
    return ct.pack_rays(p, d, static.trace_bias, maxt)


def pass_launches(scene, static, spec) -> list:
    """The packed rays of each nearest-hit trace of one render() pass."""
    captured = []
    trace_rays = ct.trace_rays

    def record(tables, rays):
        captured.append(rays.clone())
        return trace_rays(tables, rays)

    ct.trace_rays = record
    try:
        render(scene, static, spec, device=scene.device)
    finally:
        ct.trace_rays = trace_rays
    return captured


def ray_sets(device, size, pass_size) -> tuple:
    """{label: packed rays} of the fit: the K1 launches of a stand-in pass at
    ``pass_size``, bounce 1 sorted and unsorted at ``size`` and
    ``pass_size``, N_RANDOM random rays, a frame of camera rays at
    ``pass_size``. The first is the original's (bounce 1, sorted, at
    ``size``). Returns (the sets, the scene's trace tables, which do not
    depend on the frame's size)."""
    sets = {}
    tables = None
    for w, h in dict.fromkeys([tuple(size), tuple(pass_size)]):
        scene, static = compile_scene(stand_in_scene(w, h), device=device, megakernel=False)
        tables = scene.trace_tables
        spec = sampler_spec(static, device)
        for sort in (True, False):
            sets[f"bounce 1 {'sorted' if sort else 'unsorted'} {w}x{h}"] = bounce1_rays(
                scene, static, spec, sort)
        if (w, h) == tuple(pass_size):
            for k, rays in enumerate(pass_launches(scene, static, spec)):
                sets[f"pass {w}x{h} launch {k + 1}"] = rays
            sets[f"camera frame {w}x{h}"] = camera_rays(scene, static, spec)
    sets[f"random {N_RANDOM}"] = random_rays(N_RANDOM, device)
    return sets, tables


# ---------------------------------------------------------------------------
# counts, times and the fit
# ---------------------------------------------------------------------------


def warp_max_sum(row: torch.Tensor) -> float:
    """The sum over warps (32 consecutive lanes, the last one ragged) of the
    warp's largest per-lane count: the lane-steps a SIMT warp pays."""
    x = row.double()
    warps = torch.nn.functional.pad(x, (0, (-x.shape[0]) % WARP)).view(-1, WARP)
    return warps.max(1).values.sum().item()


def counts(rows: torch.Tensor) -> dict:
    """Visits, node steps and triangle tests of a nearest-hit launch (rows
    34-36): per lane, summed over warps of the warp's maximum, and both per
    1,024 lanes (the original's columns)."""
    n = rows.shape[1]
    out = {"lanes": n}
    for name, r in (("visits", 34), ("steps", 35), ("tests", 36)):
        out[f"{name}_per_lane"] = rows[r].double().mean().item()
        out[f"{name}_warp_max"] = warp_max_sum(rows[r])
        out[f"{name}_per_1024"] = out[f"{name}_warp_max"] * LANES_PER_BLOCK / n
    return out


def kernels(device) -> tuple:
    """(nearest hit, its nofetch instance, any hit) for ``device``: the
    kernels on the card, the plain walks on the CPU (the brute-force plain
    versions have no visit counts)."""
    if device.type == "cuda":
        return ct.trace_cuda, ct.trace_nofetch_cuda, ct.occluded_cuda
    return ct.trace_walk_plain, ct.trace_nofetch_plain, ct.occluded_walk_plain


def fit(ms, steps, tests, lanes) -> dict:
    """Least squares of ms ~ intercept + a steps + b tests (+ c lanes when it
    raises the adjusted R^2): the coefficients, R^2, adjusted R^2 and the
    residuals (ms)."""
    y = np.asarray(ms, np.float64)
    cols = [np.ones_like(y), np.asarray(steps, np.float64), np.asarray(tests, np.float64)]
    best = None
    for with_lanes in (False, True):
        x = np.stack(cols + ([np.asarray(lanes, np.float64)] if with_lanes else []), 1)
        n, p = x.shape
        if n <= p:
            continue
        coef = np.linalg.lstsq(x, y, rcond=None)[0]
        res = y - x @ coef
        ss_tot = float(((y - y.mean()) ** 2).sum())
        r2 = 1.0 - float((res ** 2).sum()) / ss_tot if ss_tot > 0 else 1.0
        adj = 1.0 - (1.0 - r2) * (n - 1) / (n - p)
        if best is None or adj > best["adj_r2"]:
            best = {"intercept_ms": coef[0], "ms_per_warp_step": coef[1],
                    "ms_per_warp_test": coef[2],
                    "ms_per_lane": coef[3] if with_lanes else None,
                    "r2": r2, "adj_r2": adj, "residuals_ms": res.tolist(),
                    "with_lanes": with_lanes, "sets": n}
    if best is None:
        raise ValueError(f"{len(y)} launches cannot fit {len(cols)} coefficients")
    return {k: float(v) if isinstance(v, np.floating) else v for k, v in best.items()}


def measure_set(tables, rays, device, reps: int) -> dict:
    """One ray set: K1's counts; its ms and the nofetch instance's, in turns
    (default, nofetch, nofetch, default); the lanes where the nofetch rows
    differ from the default's rows NOFETCH_ROWS (must be 0)."""
    nearest, nofetch, _ = kernels(device)
    full = nearest(tables, rays)
    part = nofetch(tables, rays)
    differ = int((full[list(ct.NOFETCH_ROWS)] != part).any(0).sum().item())
    turns = {"default": [], "nofetch": []}
    for name in ("default", "nofetch", "nofetch", "default"):
        fn = nearest if name == "default" else nofetch
        turns[name].append(timed(lambda: fn(tables, rays), device, reps))
    row = counts(full)
    ms, ms_nofetch = float(np.mean(turns["default"])), float(np.mean(turns["nofetch"]))
    row.update(ms=ms, ms_turns=turns["default"], nofetch_ms=ms_nofetch,
               nofetch_turns=turns["nofetch"], nofetch_saving_ms=ms - ms_nofetch,
               nofetch_lanes_differing=differ,
               us_per_1024=ms * 1e3 * LANES_PER_BLOCK / rays.shape[1])
    return row


def main(device="cuda", size=(960, 540), json_path=None, pass_size=(1920, 1080),
         reps: int = REPS) -> dict:
    """The original's rows on bounce-1 rays at ``size``, then every ray set
    of ``ray_sets`` and the fit. Returns the figures (and writes them to
    ``json_path``)."""
    dev = resolve_device(device)
    where = card_line() if dev.type == "cuda" else "cpu"
    sets, tables = ray_sets(dev, size, pass_size)
    rows = {}
    for label, rays in sets.items():
        r = rows[label] = measure_set(tables, rays, dev, reps)
        print(f"{label:32s} kernel {r['ms']:8.4f} ms | lanes {r['lanes']} | us/1024 lanes "
              f"{r['us_per_1024']:7.3f} | per 1024 lanes (warp max) visits "
              f"{r['visits_per_1024']:7.1f} steps {r['steps_per_1024']:7.1f} tests "
              f"{r['tests_per_1024']:8.1f} | per lane visits {r['visits_per_lane']:.3f} steps "
              f"{r['steps_per_lane']:.3f} tests {r['tests_per_lane']:.2f} | nofetch "
              f"{r['nofetch_ms']:.4f} ms (saving {r['nofetch_saving_ms']:.4f}) [{where}]",
              flush=True)
    first = next(iter(sets))
    _, _, any_hit = kernels(dev)
    any_ms = timed(lambda: any_hit(tables, sets[first]), dev, reps)
    print(f"any-hit same rays ({first}): {any_ms:.4f} ms [{where}]", flush=True)

    labels = list(rows)
    f = fit([rows[k]["ms"] for k in labels], [rows[k]["steps_warp_max"] for k in labels],
            [rows[k]["tests_warp_max"] for k in labels], [rows[k]["lanes"] for k in labels])
    for k, res in zip(labels, f["residuals_ms"]):
        rows[k]["residual_ms"] = res
        rows[k]["step_share"] = f["ms_per_warp_step"] * rows[k]["steps_warp_max"] / rows[k]["ms"]
        rows[k]["test_share"] = f["ms_per_warp_test"] * rows[k]["tests_warp_max"] / rows[k]["ms"]
    print(f"fit over {f['sets']} launches: ms = {f['intercept_ms']:.5g} + "
          f"{f['ms_per_warp_step'] * 1e6:.5g} ns x warp node steps + "
          f"{f['ms_per_warp_test'] * 1e6:.5g} ns x warp triangle tests"
          + (f" + {f['ms_per_lane'] * 1e6:.5g} ns x lanes" if f["with_lanes"] else "")
          + f"; R^2 {f['r2']:.4f} (adjusted {f['adj_r2']:.4f}) [{where}]", flush=True)
    for k in labels:
        r = rows[k]
        print(f"  {k:32s} node steps {r['step_share']:.3f} of its ms, leaves "
              f"{r['test_share']:.3f}, residual {r['residual_ms']:+.4f} ms", flush=True)
    out = {"device": str(dev), "card": where, "size": list(size), "pass_size": list(pass_size),
           "reps": reps, "original": first, "rows": rows, "any_hit_ms": any_ms, "fit": f}
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", default="960x540")
    parser.add_argument("--json", help="write the results to this file")
    args = parser.parse_args()
    main(args.device, tuple(int(v) for v in args.size.split("x")), args.json)
