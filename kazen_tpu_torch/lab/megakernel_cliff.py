"""The megakernel route's cliff: the port of ``benchmarks/megakernel_cliff.py``,
with the crossover in faces that the original does not measure.

render() sends a path_mis scene of at most 128 faces with constant textures
(``integrate/megakernel.py:supported_reason``, the reference's class) to
the megakernel K3, and every other scene to the wavefront with the trace
kernels K1/K2. Two measurements on one device:

* the cliff: the 12-face Cornell box at depth 5, 1 spp, as it is
  (``const``: K3) and with one 64x64 image texture on the back wall's
  albedo (``image_texture``: the wavefront). ``cliff_x`` is the second's
  pass time over the first's;
* the sweep: the box plus a lat-long sphere at about 12, 32, 64 and 128
  faces (never above ``MAX_BRUTE``), each compiled with ``megakernel=True``
  and with ``megakernel=False``, so one scene goes through both routes.
  ``crossover_faces`` is the first face count where the wavefront's pass
  is no slower than K3's, or None up to 128.

A pass is timed as the original times it: stream init, pixel jitter,
aperture, camera rays and the route's Li reduced to ``sum(li)``, no splat;
the mean of 4 after one warm-up, each synchronized (CUDA events on the
card). The launches of K1, K2 and K3 in the warm-up pass are recorded. The
class limits themselves are not changed here.

``python -m kazen_tpu_torch.lab.megakernel_cliff [--size WxH] [--device
cpu] [--json FILE]`` runs both on the card at 960x540 by default. The JSON
goes where ``--json`` says, never under ``benchmarks/`` (the original's
``benchmarks/megakernel_cliff_r05.json`` holds its TPU figures).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..accel import cluster_trace as ct
from ..core import rng
from ..core.device import card_line, resolve_device
from ..examples.baseline_configs import cornell_box, make_sphere, timed_ms
from ..integrate import camera as camera_mod
from ..integrate import megakernel as mk
from ..integrate.render import li_fn_for, pixel_grid, sampler_spec
from ..samplers import streams
from ..scene import description as D
from ..scene.compiler import compile_scene

VARIANTS = ("const", "image_texture")
# (n_theta, n_phi) of the sweep's sphere (None: the box alone) and the
# scene's faces, 12 + 2 (n_theta - 1) n_phi
SWEEP = ((None, 12), ((3, 5), 32), ((4, 9), 66), ((5, 14), 124))
REPS = 4
KERNELS = {"K1": ct.NEAREST, "K2": ct.ANY_HIT, "K3": mk.MEGAKERNEL}


def cliff_scene(variant: str, width: int, height: int):
    """The original's scene: the Cornell box, 1 spp, depth 5; with
    ``image_texture`` the back wall's albedo is a 64x64 linear ramp image."""
    desc = cornell_box(width=width, height=height, spp=1, max_depth=5)
    if variant == "image_texture":
        tex = np.linspace(0, 1, 64 * 64 * 3).reshape(64, 64, 3).astype(np.float32)
        desc.meshes[2].bsdf = D.Lambertian(albedo=D.ImageTexture(data=tex))
    elif variant != "const":
        raise ValueError(f"unknown variant {variant!r}")
    return desc


def sweep_scene(sphere, width: int, height: int):
    """The box plus a diffuse lat-long sphere of ``sphere`` = (n_theta,
    n_phi), or the box alone for None; 1 spp, depth 5."""
    extra = []
    if sphere is not None:
        mesh = make_sphere([0.0, 0.5, 0.2], 0.45, *sphere)
        mesh.bsdf = D.Diffuse((0.65, 0.5, 0.4))
        extra.append(mesh)
    return cornell_box(width=width, height=height, spp=1, max_depth=5, extra_meshes=extra)


def pass_fns(scene, static):
    """(one_pass, lanes): the original's timed pass, () -> (sum of li, rays
    traced), and () -> (per-lane li (N, 3), rays traced) of the same pass."""
    spec = sampler_spec(static, scene.device)
    px, py = pixel_grid(static, scene.device)
    jump = rng.advance_constants(0)
    li_fn = li_fn_for(static)

    def lanes():
        stream = streams.init_stream_jump(spec, px, py, 0, jump)
        stream, jitter = streams.next_pixel_2d(spec, stream)
        ps = torch.stack([px, py], -1).to(torch.float32) + jitter
        stream, aperture = streams.next_2d(spec, stream)
        rays = camera_mod.sample_ray(scene, static, ps, aperture)
        return li_fn(scene, static, spec, stream, rays)[1:]

    def one_pass():
        li, nrays = lanes()
        return li.sum(), nrays

    return one_pass, lanes


def pass_times(fn, device, reps: int = REPS) -> list:
    """ms of each of ``reps`` calls after one warm-up, each synchronized:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    return [timed_ms(fn, device)[1] for _ in range(reps)]


def measure(desc, device, megakernel=None) -> tuple:
    """Compile ``desc`` (``megakernel`` as compile_scene takes it) and time
    its pass. Returns (figures, per-lane (li, rays) of the pass)."""
    scene, static = compile_scene(desc, device=device, megakernel=megakernel)
    one_pass, lanes = pass_fns(scene, static)
    before = {k: v.launches for k, v in KERNELS.items()}
    _, nrays = one_pass()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: v.launches - before[k] for k, v in KERNELS.items()}
    times = pass_times(one_pass, device)
    sec = float(np.mean(times)) / 1e3
    rays = float(nrays)
    return {
        "faces": int(scene.F.shape[0]), "use_megakernel": bool(static.use_megakernel),
        "pass_seconds": sec, "pass_ms": [round(t, 4) for t in times],
        "rays_per_pass": rays, "rays_per_s": rays / sec, "launches": launches,
    }, lanes()


def agreement(got, want) -> dict:
    """Two passes' per-lane radiance: the share of lanes within rtol 1e-3 /
    atol 1e-4, the channel means' largest relative difference, the rays'."""
    (a, ra), (b, rb) = got, want
    a, b = a.double().cpu(), b.double().cpu()
    mean_a, mean_b = a.mean(0), b.mean(0)
    return {
        "lane_share": torch.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1).double().mean().item(),
        "mean_rel": ((mean_a - mean_b).abs() / mean_b.abs().clamp(min=1e-12)).max().item(),
        "rays_rel": abs(float(ra) - float(rb)) / max(float(rb), 1.0),
    }


def main(device="cuda", size=(960, 540), json_path=None, check=None) -> dict:
    """The cliff and the sweep at ``size`` on ``device``. ``check(label,
    got, want)``, when given, is called with the per-lane (li, rays) of
    each K3 pass and of the same scene's wavefront pass (the caller's gate;
    the JSON records ``agreement`` either way)."""
    dev = resolve_device(device)
    w, h = size
    where = card_line() if dev.type == "cuda" else "cpu"
    out = {"resolution": f"{w}x{h}", "device": str(dev), "card": where}
    for variant in VARIANTS:
        out[variant], _ = measure(cliff_scene(variant, w, h), dev)
        print(f"{variant}: {out[variant]} [{where}]", flush=True)
    out["cliff_x"] = out["image_texture"]["pass_seconds"] / out["const"]["pass_seconds"]
    print(f"cliff: {out['cliff_x']:.4g}x at {w}x{h} [{where}]", flush=True)

    out["sweep"], out["crossover_faces"] = [], None
    for sphere, faces in SWEEP:
        desc = sweep_scene(sphere, w, h)
        # the first is the const variant's scene: its K3 pass is held here
        row = {"sphere": sphere, "faces": faces}
        lanes = {}
        for route, flag in (("megakernel", True), ("wavefront", False)):
            row[route], lanes[route] = measure(desc, dev, megakernel=flag)
        if row["megakernel"]["faces"] != faces or faces > mk.MAX_BRUTE:
            raise AssertionError(f"sweep scene has {row['megakernel']['faces']} faces, "
                                 f"expected {faces} <= {mk.MAX_BRUTE}")
        label = f"{faces} faces, K3 vs the wavefront at {w}x{h}"
        row["agreement"] = agreement(lanes["megakernel"], lanes["wavefront"])
        if check is not None:
            check(label, lanes["megakernel"], lanes["wavefront"])
        row["ratio"] = row["wavefront"]["pass_seconds"] / row["megakernel"]["pass_seconds"]
        if out["crossover_faces"] is None and row["ratio"] <= 1.0:
            out["crossover_faces"] = faces
        out["sweep"].append(row)
        print(f"sweep {faces:4d} faces: K3 {row['megakernel']['pass_seconds'] * 1e3:.3f} ms, "
              f"wavefront {row['wavefront']['pass_seconds'] * 1e3:.3f} ms (x{row['ratio']:.4g}), "
              f"lanes agreeing {row['agreement']['lane_share']:.6f} [{where}]", flush=True)
    print("crossover: " + (f"the wavefront catches up at {out['crossover_faces']} faces"
                           if out["crossover_faces"] else
                           f"none up to {mk.MAX_BRUTE} faces") + f" [{where}]", flush=True)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", default="960x540")
    parser.add_argument("--json", help="write the results to this file")
    args = parser.parse_args()
    main(args.device, tuple(int(v) for v in args.size.split("x")), args.json)
