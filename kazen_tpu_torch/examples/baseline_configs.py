"""BASELINE.json's configurations, runnable end to end on the port: the
counterpart of ``examples/baseline_configs.py``.

  1. diffuse sphere + quad light, 64x64 @ 16 spp, independent
  2. Cornell, diffuse+GGX, NEE+MIS, 256x256 @ 128 spp, stratified
  3. kiss full stack (clearcoat+sheen, normal map, textures, thin lens) 512^2
     @ 64 spp
  4. con-2: pmj02bn + regularization + image background, 1080p @ 16 spp
  5. inverse rendering: recover the GGX sphere's roughness from a target
     (config 2's geometry at 64x64)

Every configuration has more than 128 faces (540, 2,220, 4,428, 2,220), so
render() takes the wavefront with the trace kernels K1 and K2.

Usage: python -m kazen_tpu_torch.examples.baseline_configs <1-5> [--spp N]
[--out f.png] [--device cpu|cuda] [--json f.json]. The card is the default
device; its name and power limit are printed beside the times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..core.device import card_line, resolve_device
from ..diff.inverse import optimize
from ..film.io import save_png
from ..integrate.render import render, sampler_spec
from ..scene import description as D
from ..scene.compiler import compile_scene
from ..utils.metrics import RenderMetrics

FACES = {1: 540, 2: 2220, 3: 4428, 4: 2220}
TRUE_ROUGHNESS = 0.35  # config 5's target roughness of the GGX sphere


# ---------------------------------------------------------------------------
# The scenes: copies of tests/scenes.py's Cornell box and of the original's
# make_sphere, with the port's description classes
# ---------------------------------------------------------------------------


def quad(corner, edge_u, edge_v, flip=False):
    """Two-triangle quad with normals + uvs. Normal = edge_u x edge_v."""
    c = np.asarray(corner, np.float32)
    eu = np.asarray(edge_u, np.float32)
    ev = np.asarray(edge_v, np.float32)
    verts = np.stack([c, c + eu, c + eu + ev, c + ev])
    n = np.cross(eu, ev)
    n = n / np.linalg.norm(n)
    if flip:
        n = -n
        faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    else:
        faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    normals = np.tile(n, (4, 1)).astype(np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return verts, faces, normals, uvs


def make_mesh(corner, eu, ev, bsdf=None, light=None, flip=False):
    v, f, n, uv = quad(corner, eu, ev, flip=flip)
    return D.Mesh(vertices=v, faces=f, normals=n, uvs=uv, bsdf=bsdf, light=light)


def cornell_box(
    width=32,
    height=32,
    spp=4,
    sampler="independent",
    max_depth=5,
    light_kwargs=None,
    wall_bsdf=None,
    extra_meshes=(),
    background=None,
    regularization=False,
):
    """A Cornell-style box, camera looking down +z into the box: 12 faces,
    a primary-invisible area light under the ceiling, box filter."""
    wb = wall_bsdf or D.Diffuse((0.725, 0.71, 0.68))
    red = D.Diffuse((0.63, 0.065, 0.05))
    green = D.Diffuse((0.14, 0.45, 0.091))
    lk = dict(color=(1.0, 1.0, 1.0), intensity=20.0)
    if light_kwargs:
        lk.update(light_kwargs)

    meshes = [
        # floor (y=0), normal +y
        make_mesh([-1, 0, -1], [0, 0, 2], [2, 0, 0], bsdf=wb),
        # ceiling (y=2), normal -y
        make_mesh([-1, 2, -1], [2, 0, 0], [0, 0, 2], bsdf=wb),
        # back wall (z=1): normal -z (toward camera at -z side)
        make_mesh([-1, 0, 1], [0, 2, 0], [2, 0, 0], bsdf=wb),
        # left wall (x=-1), normal +x
        make_mesh([-1, 0, -1], [0, 2, 0], [0, 0, 2], bsdf=red),
        # right wall (x=1), normal -x
        make_mesh([1, 0, -1], [0, 0, 2], [0, 2, 0], bsdf=green),
        # light: small quad under the ceiling, normal -y
        make_mesh(
            [-0.3, 1.98, -0.3], [0.6, 0, 0], [0, 0, 0.6],
            bsdf=D.Diffuse((0, 0, 0)),
            light=D.AreaLight(**lk),
        ),
    ]
    meshes.extend(extra_meshes)

    cam = D.PerspectiveCamera(
        width=width,
        height=height,
        fov=60.0,
        to_world=D.lookat(origin=[0, 1, -2.5], target=[0, 1, 0], up=[0, 1, 0]),
    )
    return D.Scene(
        meshes=meshes,
        camera=cam,
        sampler=D.Sampler(kind=sampler, sample_count=spp),
        integrator=D.PathMis(max_depth=max_depth, regularization=regularization),
        rfilter=D.RFilter(kind="box"),
        background=background,
    )


def make_sphere(center, radius, n_theta=24, n_phi=48):
    """A lat-long sphere of 2 (n_theta - 1) n_phi faces with smooth normals
    and uvs; the grid is built in float64 and cast once to float32."""
    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    verts = (center + radius * pts).astype(np.float32)
    normals = pts.astype(np.float32)
    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    uvs = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)
    return D.Mesh(
        vertices=verts,
        faces=np.asarray(faces, np.int32),
        normals=normals,
        uvs=uvs.astype(np.float32),
    )


def config_scene(n, spp=None):
    """The description of configuration ``n`` (1-4) at its published size
    and spp (``spp`` overrides the sample count)."""
    if n == 1:
        sphere = make_sphere([0.0, 0.6, 0.0], 0.6, 12, 24)
        sphere.bsdf = D.Diffuse((0.65, 0.5, 0.4))
        return cornell_box(width=64, height=64, spp=spp or 16, extra_meshes=[sphere])
    if n == 2:
        sphere = make_sphere([0.4, 0.5, 0.3], 0.5)
        sphere.bsdf = D.GGX(albedo=D.ConstantTexture((0.9, 0.7, 0.3)), roughness=0.2)
        return cornell_box(
            width=256, height=256, spp=spp or 128, sampler="stratified",
            extra_meshes=[sphere],
        )
    if n == 3:
        checker = np.zeros((64, 64, 3), np.float32)
        checker[::8, :] = 1.0
        checker[:, ::8] = 1.0
        bump = np.full((32, 32, 3), (0.5, 0.5, 1.0), np.float32)
        bump[::4, :, 0] = 0.7
        sphere = make_sphere([-0.4, 0.6, 0.2], 0.6)
        sphere.bsdf = D.KazenStandard(
            base_color=D.ImageTexture(data=checker, colorspace="linear"),
            roughness=D.ConstantTexture((0.25,) * 3),
            metallic=D.ConstantTexture((0.4,) * 3),
            clearcoat=0.8,
            sheen=0.5,
        )
        sphere2 = make_sphere([0.6, 0.4, -0.2], 0.4)
        sphere2.bsdf = D.NormalMap(
            nested=D.KazenStandard(
                base_color=D.ConstantTexture((0.8, 0.3, 0.2)),
                roughness=D.ConstantTexture((0.15,) * 3),
            ),
            normals=D.ImageTexture(data=bump, colorspace="linear"),
        )
        sc = cornell_box(width=512, height=512, spp=spp or 64, extra_meshes=[sphere, sphere2])
        sc.camera = D.ThinlensCamera(
            width=512, height=512, fov=60.0,
            to_world=D.lookat([0, 1, -2.5], [0, 1, 0], [0, 1, 0]),
            aperture_radius=0.05, focus_distance=2.4,
        )
        return sc
    if n == 4:
        env = np.zeros((32, 64, 3), np.float32)
        env[:12] = (0.3, 0.5, 0.9)  # sky
        env[12:] = (0.15, 0.12, 0.1)
        sphere = make_sphere([0.0, 0.55, 0.0], 0.55)
        sphere.bsdf = D.KazenStandard(
            base_color=D.ConstantTexture((0.7, 0.6, 0.5)),
            roughness=D.ConstantTexture((0.1,) * 3),
            metallic=D.ConstantTexture((0.7,) * 3),
        )
        return cornell_box(
            width=1920, height=1080, spp=spp or 16, sampler="pmj02bn",
            extra_meshes=[sphere], regularization=True,
            background=D.Background(
                texture=D.ImageTexture(data=env, colorspace="linear"), intensity=1.0,
            ),
        )
    raise ValueError(f"config {n} has no scene of its own (1-4; 5 is run_inverse)")


def at_size(desc, width, height):
    """``desc`` with its camera resized to ``width`` x ``height`` (in
    place; returned for chaining)."""
    desc.camera.width, desc.camera.height = width, height
    return desc


# ---------------------------------------------------------------------------
# Running them
# ---------------------------------------------------------------------------


def timed_ms(fn, device):
    """(fn(), its ms): CUDA events and a synchronize on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def run_config(n, spp=None, device="cuda", verbose=True) -> dict:
    """Compile configuration ``n`` (1-4) and render it at its published size
    and spp (or ``spp``) with a RenderMetrics. The sampler's tables (pmj02bn
    for config 4) are built once before the render and given to it; their
    build is timed apart. Returns the figures and the image (``image``, an
    (H, W, 3) tensor on ``device``)."""
    dev = resolve_device(device)
    desc = config_scene(n, spp)
    t0 = time.perf_counter()
    scene, static = compile_scene(desc, device=dev)
    compile_s = time.perf_counter() - t0
    spec, spec_ms = timed_ms(lambda: sampler_spec(static, dev), dev)
    metrics = RenderMetrics()
    img, render_ms = timed_ms(
        lambda: render(scene, static, spec, spp=spp, verbose=verbose, metrics=metrics,
                       device=dev), dev)
    summary = metrics.summary()
    passes = summary["passes"]
    lanes = static.width * static.height
    pass_ms = sorted(p.seconds * 1e3 for p in metrics.passes)
    return {
        "config": n, "width": static.width, "height": static.height, "spp": passes,
        "sampler": static.sampler_kind, "faces": int(scene.F.shape[0]),
        "clusters": scene.trace_tables.num_clusters, "megakernel": static.use_megakernel,
        "compile_s": compile_s, "spec_ms": spec_ms, "render_s": render_ms / 1e3,
        "ms_per_pass": render_ms / passes,
        # each pass's seconds as RenderMetrics took them: device-clock time
        # between the pass's CUDA events on the card (no sync in the call)
        "pass_ms_min": pass_ms[0], "pass_ms_median": pass_ms[len(pass_ms) // 2],
        "pass_ms_max": pass_ms[-1],
        "rays_per_pass": summary["rays"] / passes,
        "rays_per_s": summary["rays"] / (render_ms / 1e3),
        "pixel_samples_per_s": lanes * passes / (render_ms / 1e3),
        "metrics": summary, "device": str(dev), "image": img,
    }


def with_roughness(arrays, value):
    """``arrays`` whose last material (config 2's GGX sphere) has roughness
    ``value``, on a copy of the material table."""
    rough = arrays.materials.roughness.clone()
    rough[-1] = value
    return dataclasses.replace(
        arrays, materials=dataclasses.replace(arrays.materials, roughness=rough))


def inverse_scene(size=64, spp=8, device="cuda"):
    """Config 5's scene: config 2's geometry at ``size`` x ``size``, ``spp``
    samples, compiled on ``device``."""
    return compile_scene(at_size(config_scene(2, spp=spp), size, size),
                         device=resolve_device(device))


def run_inverse(device="cuda", size=64, spp=8, steps=80, spp_per_step=2) -> dict:
    """Config 5 as the original's main(): the target rendered at ``spp``
    with the sphere's roughness at TRUE_ROUGHNESS, then ``steps`` Adam
    steps on the material table from the compiled roughness. Returns the
    recovered roughness, each step's loss and ms, and the target's ms."""
    dev = resolve_device(device)
    arrays, static = inverse_scene(size, spp, dev)
    target, target_ms = timed_ms(
        lambda: render(with_roughness(arrays, TRUE_ROUGHNESS), static, spp=spp, device=dev), dev)
    stamps = [time.perf_counter()]

    def tick(it, loss, params):  # optimize reads each loss back: the step is done
        stamps.append(time.perf_counter())

    res = optimize(arrays, static, target, steps=steps, spp_per_step=spp_per_step,
                   param_keys=("materials",), callback=tick)
    step_ms = np.diff(stamps) * 1e3
    return {
        "config": 5, "width": size, "height": size, "target_spp": spp, "steps": steps,
        "spp_per_step": spp_per_step, "true_roughness": TRUE_ROUGHNESS,
        "initial_roughness": float(arrays.materials.roughness[-1]),
        "recovered_roughness": float(res.params["materials"]["roughness"][-1]),
        "losses": res.losses.tolist(), "step_ms": step_ms.tolist(),
        "ms_per_step": float(step_ms.mean()), "target_ms": target_ms, "device": str(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", type=int, choices=(1, 2, 3, 4, 5))
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", default=None, help="write the figures to this file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = card_line() if dev.type == "cuda" else "cpu"
    if args.config == 5:
        res = run_inverse(dev)
        for it, (loss, ms) in enumerate(zip(res["losses"], res["step_ms"])):
            print(f"step {it}: loss {loss:.6g}, {ms:.1f} ms [{where}]")
        print(f"recovered roughness {res['recovered_roughness']:.3f} (true {TRUE_ROUGHNESS})")
    else:
        res = run_config(args.config, args.spp, dev)
        print(f"compiled {res['faces']} faces in {res['compile_s']:.1f}s")
        img = res.pop("image")
        print(f"rendered in {res['render_s']:.1f}s: {res['metrics']} [{where}]")
        print(f"{res['ms_per_pass']:.2f} ms a pass, {res['rays_per_s']:.4g} rays/s, "
              f"{res['pixel_samples_per_s']:.4g} pixel-samples/s [{where}]")
        out = args.out or f"config{args.config}.png"
        save_png(out, img.cpu())
        print(f"wrote {out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(res, card=where), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
