"""Drive the PyTorch/CUDA port (kazen_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Two paths of render() are driven: the ordered wavefront with the trace
kernels K1/K2 on the stand-in scene (36,876 faces), and the megakernel K3 on
scenes of at most 128 faces (Mixed 1080p: the Cornell box with kiss, mirror,
GGX, dielectric and lambertian quads, 22 faces, depth 5; Toy 1080p: the
12-triangle diffuse/kiss box, depth 4). On the wavefront's kernels run also
the pmj02bn sampler, the four debug integrators,
Textured 1080p (the stand-in with image textures, a normal map, the rough*
models and an importance-sampled sky), inverse rendering (optimize), the
XML/OBJ/PNG/EXR front end with checkpoints and the CLI, and dist/ on nccl.
A third path is the lab probes' tables (kazen_tpu_torch/lab/, K4-K6).
BASELINE.json's configurations 1-5 run on the wavefront at their published
sizes; the megakernel's cliff and K1's split between node steps and leaves
are measured by the ports of benchmarks/megakernel_cliff.py and
benchmarks/kernel_ablate.py.

Phases (each check raises; the script exits non-zero on the first failure):

0. Build the CUDA trace kernels, the megakernel and the lab probes (nvcc,
   sm_90a, one library each) and the native BVH builder (g++) from the
   sources in the checkout, in parallel; log each kernel's registers and
   spills (K1/K2's serial and cooperative drains are one kernel, so one
   line serves both; K1's nofetch instance has its own; K3's for each
   instance __launch_bounds__(128, B), B in MIN_BLOCKS_CHOICES).
1. K1/K2 against their plain PyTorch versions on the card, on the stand-in
   scene (Cornell box + a 36,864-triangle kiss sphere): 262,144 seeded
   random rays and one 1920x1080 frame of camera rays; and against their
   plain walks on 65,536-lane slices of both (rows 0-36, any hit 0-3, equal
   on >= 99.99% of lanes).
2. One 1-spp depth-5 sample pass at 64x36, on the card through the kernels
   and on the CPU through the plain versions: per-lane radiance compared.
3. The wavefront path: render() at 1920x1080, 1 spp, depth 5 -- one warm-up
   pass with every kernel's launch count set to 0 before it and read after
   it (K1 and K2 launched, K3 not), then three passes timed with CUDA events.
4. K1/K2 replayed on the inputs they received in one pass (ms per launch),
   held against their plain versions on the first and the third of them (and
   the third's first 65,536 lanes against the plain walk), the plain
   version's time, and the kernel's bound. On every launch: the SIMT
   efficiency of leaves and of node steps (the mean per lane of the tests
   and steps rows over the mean across warps of the warp's maximum), ms per
   launch at each drain threshold min_idle of MIN_IDLE_SWEEP in turns, and
   the count of lanes whose rows differ from min_idle 33 (every lane tests
   its own leaves); then the stand-in pass with both kernels at min_idle
   33 against the module constant, in turns.
5. One pass of each path (stand-in, Mixed 1080p) under torch.profiler:
   device busy time and the kernels that take it (the full lists go to
   chiprun_out/).
6. K3 against its plain version on the card: the Mixed 1080p sample-0 camera
   rays and streams; at 64x36 the stratified and correlated samplers, and
   regularization with a background, with and without lights. Rows 0-5 must
   be equal on every lane, for both schedules (refill 0 and 1); the count
   of lanes that differ is printed, and the radiance gate is applied too.
7. K3 against the port's li_wavefront on the card, on the same inputs.
8. The megakernel path at 64x36 on the card against the same path on the
   CPU (the plain version).
9. The megakernel path: render() at 1920x1080 on Mixed and on Toy -- launch
   counts set to 0 before a warm-up pass and read after it (K3 once, K1/K2
   never), the image checked, three passes timed with CUDA events; then K3
   replayed on the input of the pass's launch: ms per launch and bound at
   the wrapper's constants, then every schedule (refill 0, 1) x instance B
   in turns, with each one's registers, local bytes, resident blocks and
   lane-slot efficiency (the threads that held a path over 32 x the warps'
   iterations), the one-lane-a-thread figure from row 5, and a check that the
   totals of rows 4 and 5 are equal across all of them.

10. (Absent: it ran the staged wavefront driver, which was retired; the
    later phases keep their numbers.)
11. pmj02bn on the stand-in: card against CPU at 64x36, one timed 1080p
    pass.
12. The debug integrators normals, ao, whitted (depth 16, its cap) and
    path_mats on the stand-in: card against CPU at 64x36 and a timed 1080p
    pass each, K1 launched (their shadow tests are nearest-hit queries).
    Whitted decides a shadow test by the last bit where the light hits its
    own shadow ray's end, so it is held by the full gate to the same pass on
    the card with K1 replaced by the plain walk, and to the CPU by channel
    means and rays (the lane share is logged).
13. Textured 1080p: card against CPU at 64x36; the 1080p pass timed, K1
    and K2 launched, the image finite with mean > 0; the lane-chunked
    render (lane_chunk = 2**18, scatter splat) against the grid splat.

14. Gradients on the card: (a) d mean((img - target)^2) with respect to
    every material float field, the light radiance and the background
    colour on the stand-in at 64x36 (through K1/K2) against the same on the
    CPU (the plain walks), and the texels' on Textured; each field within
    allclose(rtol=1e-3, atol=1e-3 max|g_cpu|); (b) finite differences
    against autodiff at 1920x1080, depth 2, for a box wall's and the kiss
    sphere's base_color (tests/test_grad.py's 2e-3 criterion); (c) five
    optimize steps at 1920x1080, depth 5, on the kiss sphere's base_color and
    roughness from wrong values (the step runs at the largest of 1920x1080,
    1440x810 and 960x540 whose peak memory, extrapolated from a 960x540
    step, fits 85% of the card): ms per step, forward and backward ms,
    device time, peak memory, the losses (which must fall) and K1/K2/K3
    launches (the backward launches none); (d) Mixed compiled for the card
    (K3 on) gives optimize the gradient of the same scene compiled with K3
    off, nonzero, and K3 is not launched.
15. The file front end: the stand-in written as OBJ files and a scene XML,
    with an sRGB 8-bit PNG baseColor (Textured's 1024x1024 image) and an
    EXR sky; loaded, rendered at 1 spp by render_resumable with a
    checkpoint, resumed to 2 spp by the CLI into an EXR, and held against
    render() of the same description built in memory from the decoded
    arrays.
16. dist/ in a process group of one on nccl: render_distributed of the
    stand-in at 1080p against render(), inverse_train_step against phase
    14's single-process gradient, and the CLI with --distributed.
17. The lab probes (phase_lab, which can run alone after phase 0): the
    lab kernels' registers and spills (none allowed); K6's wgmma layout
    check (its DEFAULT and bf16 configurations and K = 100 and 36, 8 blocks
    of 7 visits, on integer geo in [-8, 8], where every sum is exact: rows,
    counts and fetches equal, least t within rtol 1e-6); then the launch
    counts set to 0 before mxu_lab.main() and visit_lab.main() (the
    originals' tables: K4 at each (precision, M, K), N 1024, 512 reps; K5 on
    (512, 1024); K6 at its 8 configurations, blocks 506, visits 40, on geo
    of ones) and read after, each above 0; their ms per launch. Then K4 at
    every shape and at K = 8 and 40 (M = 128, each precision) against its
    plain version (max abs err <= 1e-5 x max), its TFLOP/s, plain and
    library ms (512 x torch.mm + add_; wall and, under torch.profiler,
    device time) and bound, and at M=1024, K=128 its ms at 512 reps >= 6x
    its ms at 64 (in turns); K5 on a seeded uniform (512, 1024) in [0, 1)
    and in [-1, 1): outputs and accepted counts equal, least t within rtol
    1e-6; K5's device time a launch (torch.profiler, the median of 21
    single launches) beside an empty kernel's at its launch shape (the
    floor) and its call time (CUDA events over 20 Python calls); K6 at each
    configuration on a seeded geo where tests are accepted: rows, counts
    and fetches (0) equal, least t within rtol 1e-6, its design, TFLOP/s
    of products, plain ms and bound.
18. The measuring scripts (phase_measure): kazen_tpu_torch/lab/
    profile_pass2.py's rows on the stand-in at 1080p (the full pass, K1
    sorted with the ordered permute and unsorted, K2 in the packet order,
    the argsort and both gathers of the permute, the primary intersect),
    each in event ms and device ms; the stage attribution of a stand-in,
    a pmj02bn and a Textured pass from torch.profiler's Python stacks
    (device, wall and host ms and launches per stage and bounce; named
    stages must hold >= 95% of each pass's device time and every device
    activity must be traced to its launch), pmj02bn's syncs and its pass
    with the sampler's tables built by render() and given to it, and
    Textured's texture-fetch sites; then every row of glue_lab.py at
    2,073,600 lanes, each alternative equal to its plain row.

19. BASELINE.json's configurations (phase_baseline,
    kazen_tpu_torch/examples/baseline_configs.py): configs 1-4 at 64
    pixels wide (config 4 64x36), 1 spp, card against the CPU port; config
    1 at 64x64, 16 spp, through render(), the card's image against the
    CPU's; configs 1-4 at their published sizes and spp, save configs 2
    and 3 at BASELINE_SPP's 9 and 8 (their published spp run through the
    module on its own), by run_config, with the launch counts set to 0 before each and read after
    (K1 and K2 on every pass, K3 never): ms a pass, rays/s, pixel-samples/s,
    K1/K2 launches a pass, and one pass under torch.profiler (device ms,
    launches, busy share; config 4 also with its pmj02bn tables built by
    render() and given to it); config 5 (optimize, 80 steps at 64x64): ms a
    step, losses finite and falling, the recovered roughness within
    CONFIG5_TOLERANCE of kazen_tpu's on the CPU, and its first step's
    loss and gradients against the CPU port's (rtol 1e-3, gradients atol
    1e-3 x the table's largest).
20. The megakernel route's cliff (phase_cliff,
    kazen_tpu_torch/lab/megakernel_cliff.py) at 960x540 and 1920x1080: the
    constant box through K3 (K3 once a pass, no K1/K2) and the textured one
    through the wavefront (K1 and K2, no K3), cliff_x; the sweep of the box
    plus a sphere at 12-124 faces through both routes, each K3 pass held by
    check_li to its wavefront pass.
21. K1's split between node steps and leaves (phase_ablate,
    kazen_tpu_torch/lab/kernel_ablate.py): K1 and its nofetch instance on
    13 ray sets of the stand-in (the 1080p pass's K1 launches, bounce 1
    sorted and unsorted at 960x540 and 1080p, random rays, a camera frame),
    the nofetch rows equal to the default's on every lane; the original's
    columns, K2 on the original's rays, the least-squares fit of K1's ms on
    the warps' node steps and triangle tests; K1's rows 0-36 against the
    plain walk on 65,536 bounce-1 lanes.
22. The shade kernel (phase_shade, kazen_tpu_torch/lab/shade_check.py): one
    pass of config 4 (con-2, 1920x1080), config 2 (256x256) and the mixed
    box (every lobe of the kernel's set; with a sphere, several clusters,
    and without, one) with every bounce's shade stage run by the kernel
    and by the plain version on the same inputs, each column equal bit for
    bit; the main path launched the kernel (``shade_route`` kernel on every
    bounce, one launch each); its ms a launch, its bytes bound and the
    plain version's ms; then ``shade_route`` of a con-2 render() pass
    (kernel on every bounce) and of config 3 and Textured render() passes
    and a con-2 optimize() step (plain on every bounce).

Each of phases 11-22 logs its seconds, and the script its total. Phases
17-22 can run alone after phase 0's builds (phase_lab, phase_measure,
phase_baseline, phase_cliff, phase_ablate, phase_shade).
Every comparison of radiance holds PERF.md's gate: per-lane radiance within
rtol 1e-3 / atol 1e-4 on >= 99% of lanes, channel means within 0.5% and ray
totals within 0.1%.

The second-to-last line is the JSON kernel table; the last line is
{"ok": true, "device": {...}}. Without CUDA the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The stand-in scene (a full-size configuration of the class the hero scene
# belongs to: 36,876 faces, kiss material, primary-invisible area light)
WIDTH, HEIGHT, DEPTH = 1920, 1080, 5
SPHERE_NU, SPHERE_NV = 192, 96
SMALL_W, SMALL_H = 64, 36
# the frame of the original measuring scripts (benchmarks/megakernel_cliff.py,
# benchmarks/kernel_ablate.py)
ORIGINAL_W, ORIGINAL_H = 960, 540
N_RANDOM = 262_144
N_WALK = 65_536  # lanes held against the plain walk per ray set
SEED = 7
# drain thresholds timed in phase 4; 33 never drains cooperatively (every
# lane tests its own leaves) and is the reference every other value is held to
MIN_IDLE_SWEEP = (0, 4, 8, 16, 24, 33)
SERIAL = 33

# H100 SXM published peaks (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# K3 is built with -fmad=false: no product and sum issue as one FMA, so its
# reachable f32 rate is half the peak's (which counts an FMA as two)
PEAK_F32_UNFUSED = PEAK_F32_FLOPS / 2
# flops of one Moller-Trumbore test as accel/intersect.py writes it:
# 2 cross products (9 each), 4 dot products (5 each), 3 subtractions,
# 1 division, 3 scalings by 1/det
MT_FLOPS = 2 * 9 + 4 * 5 + 3 + 1 + 3
# f32 operations of one megakernel bounce besides its triangle tests, read
# from csrc/megakernel.cu for a diffuse bounce with NEE, counting sqrt, sin,
# cos and a division as one each: hit point 48, shading frame 45, local wi
# 15, light sample 60, BSDF eval 10, MIS 10, BSDF sample 20, world wo 15,
# emitter MIS 20, stream draws 8 (integer work not counted). Kiss and GGX
# bounces cost more, so this undercounts, as a bound may.
SHADE_FLOPS = 48 + 45 + 15 + 60 + 10 + 10 + 20 + 15 + 20 + 8
# the rows a consumer of K3 reads: rays o, d (6 f32) and the six int64
# stream fields in, li rgb and the ray count (4 f32) out, per lane
K3_IO_BYTES = 6 * 4 + 6 * 8 + 4 * 4


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------


def _quad(D, corner, eu, ev, bsdf=None, light=None):
    c = np.asarray(corner, np.float32)
    eu = np.asarray(eu, np.float32)
    ev = np.asarray(ev, np.float32)
    verts = np.stack([c, c + eu, c + eu + ev, c + ev])
    n = np.cross(eu, ev)
    n = n / np.linalg.norm(n)
    return D.Mesh(
        vertices=verts,
        faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.tile(n, (4, 1)).astype(np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        bsdf=bsdf,
        light=light,
    )


def _sphere(D, center, radius, nu, nv, bsdf):
    c = np.asarray(center, np.float32)
    uu, vv = np.meshgrid(
        np.linspace(0.0, 2.0 * np.pi, nu + 1, dtype=np.float32),
        np.linspace(0.0, np.pi, nv + 1, dtype=np.float32),
        indexing="ij",
    )
    normals = np.stack(
        [np.sin(vv) * np.cos(uu), np.cos(vv), np.sin(vv) * np.sin(uu)], -1
    ).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu / (2.0 * np.pi), vv / np.pi], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b = ((i + 1) * (nv + 1) + j).reshape(-1)
    cc = ((i + 1) * (nv + 1) + j + 1).reshape(-1)
    d = (i * (nv + 1) + j + 1).reshape(-1)
    faces = np.stack([np.stack([a, b, cc], 1), np.stack([a, cc, d], 1)], 1)
    return D.Mesh(
        vertices=(c + radius * normals).astype(np.float32),
        faces=faces.reshape(-1, 3).astype(np.int32),
        normals=normals,
        uvs=uvs.astype(np.float32),
        bsdf=bsdf,
    )


def _box_scene(D, meshes, width, height, depth, rfilter, sampler="independent", spp=1,
               regularization=False, background=None, integrator=None):
    cam = D.PerspectiveCamera(
        width=width, height=height, fov=60.0,
        to_world=D.lookat(origin=[0, 1, -2.5], target=[0, 1, 0], up=[0, 1, 0]),
    )
    return D.Scene(
        meshes=meshes, camera=cam,
        sampler=D.Sampler(kind=sampler, sample_count=spp, seed=1),
        integrator=integrator or D.PathMis(max_depth=depth, regularization=regularization),
        rfilter=D.RFilter(kind=rfilter),
        background=background,
    )


def _cornell_meshes(D, wall=None):
    """The Cornell box of tests/scenes.py with its primary-invisible area
    light (punch-through and the any-hit light skip both run)."""
    wall = wall or D.Diffuse((0.725, 0.71, 0.68))
    return [
        _quad(D, [-1, 0, -1], [0, 0, 2], [2, 0, 0], wall),
        _quad(D, [-1, 2, -1], [2, 0, 0], [0, 0, 2], wall),
        _quad(D, [-1, 0, 1], [0, 2, 0], [2, 0, 0], wall),
        _quad(D, [-1, 0, -1], [0, 2, 0], [0, 0, 2], D.Diffuse((0.63, 0.065, 0.05))),
        _quad(D, [1, 0, -1], [0, 0, 2], [0, 2, 0], D.Diffuse((0.14, 0.45, 0.091))),
        _quad(
            D, [-0.3, 1.98, -0.3], [0.6, 0, 0], [0, 0, 0.6], D.Diffuse((0, 0, 0)),
            light=D.AreaLight(color=(1.0, 1.0, 1.0), intensity=20.0),
        ),
    ]


def stand_in_scene(D, width, height, sampler="independent", integrator=None, depth=DEPTH):
    """Cornell box + lat-long kiss sphere, 1 spp, depth 5, gaussian filter;
    the independent sampler and path_mis unless asked otherwise."""
    sphere = _sphere(
        D, [0.0, 0.7, 0.2], 0.6, SPHERE_NU, SPHERE_NV,
        D.KazenStandard(base_color=(0.6, 0.4, 0.8), metallic=0.3, roughness=0.3),
    )
    return _box_scene(D, _cornell_meshes(D) + [sphere], width, height, depth, "gaussian",
                      sampler=sampler, integrator=integrator)


def _bump_normals(res, rng):
    """A tangent-space normal map of smooth random bumps, as linear RGB."""
    x = np.arange(res) * (2 * np.pi / res)
    h = sum(
        rng.rand() * np.sin(k * x[:, None] + rng.rand() * 6.0) * np.cos(k * x[None, :])
        for k in (3, 7, 13)
    )
    gy, gx = np.gradient(h)
    n = np.stack([-gx * res / 40.0, -gy * res / 40.0, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (0.5 * n + 0.5).astype(np.float32)


def kiss_base_image(rng, res=1024):
    """Textured's sRGB baseColor: diagonal stripes with seeded noise, (res,
    res, 3) in [0, 1]."""
    u = np.linspace(0.0, 1.0, res, dtype=np.float32)
    stripes = 0.5 + 0.5 * np.sin(2 * np.pi * 24 * (u[:, None] + 0.3 * u[None, :]))
    base = np.stack([0.2 + 0.6 * stripes, 0.3 + 0.3 * (1 - stripes), 0.7 - 0.4 * stripes], -1)
    return np.clip(base + 0.1 * rng.rand(res, res, 3), 0.0, 1.0).astype(np.float32)


def textured_scene(D, width, height):
    """Textured: the stand-in with this slice's features. The sphere's kiss
    baseColor (sRGB) and roughness are 1024x1024 images; the floor is a
    normalmap (512x512 tangent-space bumps) over diffuse; roughconductor,
    roughplastic and roughdielectric quads face the camera; the background
    is a 512x256 lat-long sky with a bright sun, importance-sampled.
    pmj02bn, 1 spp, depth 5, gaussian filter, mip filtering with EWA probes.
    Every image is made from SEED."""
    rng = np.random.RandomState(SEED)
    res = 1024
    base = kiss_base_image(rng, res)
    rough = (0.15 + 0.5 * rng.rand(res, res)).astype(np.float32)
    sphere = _sphere(
        D, [0.0, 0.7, 0.2], 0.6, SPHERE_NU, SPHERE_NV,
        D.KazenStandard(
            base_color=D.ImageTexture(data=base),
            roughness=D.ImageTexture(data=rough, colorspace="linear"),
            metallic=0.3,
        ),
    )
    meshes = _cornell_meshes(D)
    meshes[0] = _quad(D, [-1, 0, -1], [0, 0, 2], [2, 0, 0], D.NormalMap(
        nested=D.Diffuse((0.725, 0.71, 0.68)),
        normals=D.ImageTexture(data=_bump_normals(512, rng), colorspace="linear"),
    ))
    quads = [
        _quad(D, [-0.95, 1.25, 0.9], [0, 0.5, 0], [0.5, 0, 0],
              D.RoughConductor(material="Au", alpha=0.3)),
        _quad(D, [0.45, 1.25, 0.9], [0, 0.5, 0], [0.5, 0, 0],
              D.RoughPlastic(alpha=0.25, kd=(0.2, 0.45, 0.7))),
        _quad(D, [-0.3, 0.05, -0.5], [0, 0.4, 0], [0.6, 0, 0],
              D.RoughDielectric(roughness=0.2)),
    ]
    sky = np.full((256, 512, 3), 0.08, np.float32) + 0.04 * rng.rand(256, 512, 3).astype(np.float32)
    sky[64:80, 160:184] = (80.0, 70.0, 50.0)  # the sun
    background = D.Background(
        texture=D.ImageTexture(data=sky, colorspace="linear"), intensity=1.0, importance=True
    )
    return _box_scene(D, meshes + [sphere] + quads, width, height, DEPTH, "gaussian",
                      sampler="pmj02bn", background=background)


def mixed_scene(D, width, height, sampler="independent", spp=1):
    """Mixed: the Cornell box plus one quad each of kiss, mirror, GGX and
    dielectric (where tests/test_megakernel.py puts them) and lambertian,
    all facing the camera: 22 faces, every BSDF branch of K3. Depth 5, box
    filter."""
    quads = [
        _quad(D, [-0.8, 0.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], D.KazenStandard(
            base_color=(0.7, 0.3, 0.2), metallic=0.4, roughness=0.35, clearcoat=0.6,
            sheen=0.4,
        )),
        _quad(D, [0.2, 0.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], D.Mirror()),
        _quad(D, [-0.8, 0.8, 0.6], [0, 0.6, 0], [0.6, 0, 0],
              D.GGX(albedo=(0.9, 0.7, 0.4), roughness=0.2)),
        _quad(D, [0.2, 0.8, 0.6], [0, 0.6, 0], [0.6, 0, 0], D.Dielectric()),
        _quad(D, [-0.3, 1.3, 0.9], [0, 0.5, 0], [0.6, 0, 0],
              D.Lambertian(albedo=D.ConstantTexture((0.3, 0.6, 0.5)))),
    ]
    return _box_scene(D, _cornell_meshes(D) + quads, width, height, DEPTH, "box", sampler, spp)


def variant_scene(D, width, height, light=True):
    """The box with kiss walls, roughness regularization and a constant
    background (tests/test_megakernel.py's regularization case), with its
    light or without: the branches of K3 that Mixed and Toy leave out."""
    meshes = _cornell_meshes(D, D.KazenStandard(base_color=(0.6, 0.6, 0.6), roughness=0.4))
    background = D.Background(texture=D.ConstantTexture((0.2, 0.3, 0.4)), intensity=1.5)
    return _box_scene(
        D, meshes if light else meshes[:-1], width, height, DEPTH, "box",
        regularization=True, background=background,
    )


def toy_scene(D, width, height):
    """Toy: the 12-triangle box the reference's bench tracked (diffuse walls,
    a kiss back wall, a primary-invisible light), depth 4, box filter."""
    gray = D.Diffuse((0.7, 0.7, 0.7))
    meshes = [
        _quad(D, [-1, 0, -1], [0, 0, 2], [2, 0, 0], gray),
        _quad(D, [-1, 2, -1], [2, 0, 0], [0, 0, 2], gray),
        _quad(D, [-1, 0, 1], [0, 2, 0], [2, 0, 0], D.KazenStandard()),
        _quad(D, [-1, 0, -1], [0, 2, 0], [0, 0, 2], D.Diffuse((0.6, 0.1, 0.1))),
        _quad(D, [1, 0, -1], [0, 0, 2], [0, 2, 0], D.Diffuse((0.1, 0.6, 0.1))),
        _quad(D, [-0.3, 1.98, -0.3], [0.6, 0, 0], [0, 0, 0.6], D.Diffuse((0, 0, 0)),
              light=D.AreaLight(intensity=15.0)),
    ]
    return _box_scene(D, meshes, width, height, 4, "box")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def camera_rays(torch, scene, static, spec, sample=0):
    """One frame of camera rays and their streams, as the render pass makes
    them for sample pass ``sample``."""
    from kazen_tpu_torch.core import rng
    from kazen_tpu_torch.integrate import camera as camera_mod
    from kazen_tpu_torch.integrate.render import pixel_grid
    from kazen_tpu_torch.samplers import streams

    px, py = pixel_grid(static, scene.device)
    stream = streams.init_stream_jump(
        spec, px, py, sample, rng.advance_constants(sample * 65536)
    )
    stream, jitter = streams.next_pixel_2d(spec, stream)
    stream, aperture = streams.next_2d(spec, stream)
    ps = torch.stack([px, py], -1).to(torch.float32) + jitter
    return stream, camera_mod.sample_ray(scene, static, ps, aperture)


def check_nearest(torch, ct, tables, rays, label, phase=1):
    """K1 vs its plain version: same face on >= 99% of lanes, rows 0-33
    within rtol 1e-4 / atol 1e-4 there (tests/test_cluster_trace.py's
    limits for the TPU kernel). Returns (max abs err, same-face share, ms of
    the plain version's call)."""
    rk = ct.trace_cuda(tables, rays)
    rp, plain_ms = timed(torch, lambda: ct.trace_plain(tables, rays))
    same = rk[3] == rp[3]
    share = same.float().mean().item()
    if share < 0.99:
        raise AssertionError(f"K1 {label}: same face on {share:.5f} of lanes (< 0.99)")
    a, b = rk[:34, same], rp[:34, same]
    if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
        bad = (~torch.isclose(a, b, rtol=1e-4, atol=1e-4)).any(0).sum().item()
        raise AssertionError(f"K1 {label}: rows 0-33 differ beyond 1e-4 on {bad} lanes")
    err = (a - b).abs().max().item()
    log(f"phase {phase}: K1 {label}: N={rays.shape[1]} same face {share:.6f}, "
        f"rows 0-33 max abs err {err:.3g}, hit share {(rk[3] >= 0).float().mean().item():.4f}")
    return err, share, plain_ms


def check_any_hit(torch, ct, tables, rays, label, phase=1):
    """K2 vs its plain version: agreement on >= 99.9% of lanes. Returns (max
    abs err, agreement, ms of the plain version's call)."""
    ok = ct.occluded_cuda(tables, rays)[0]
    op, plain_ms = timed(torch, lambda: ct.occluded_plain(tables, rays)[0])
    agree = (ok == op).float().mean().item()
    if agree < 0.999:
        raise AssertionError(f"K2 {label}: agreement {agree:.6f} (< 0.999)")
    err = (ok - op).abs().max().item()
    log(f"phase {phase}: K2 {label}: N={rays.shape[1]} agreement {agree:.6f}, "
        f"blocked share {ok.mean().item():.4f}")
    return err, agree, plain_ms


def check_walk(torch, ct, tables, rays, label, phase=1, start=0):
    """K1 and K2 against their plain walks on N_WALK lanes of ``rays`` from
    ``start`` (K2 with maxt capped at 1.5): rows 0-36 of the nearest hit and
    0-3 of the any hit equal on >= 99.99% of lanes. Returns the share of
    lanes equal, the smaller of the two."""
    sl = rays[:, start:start + N_WALK].contiguous()
    short = sl.clone()
    short[7] = torch.clamp(short[7], max=1.5)
    shares = []
    for name, kfn, wfn, x, rows in (
        ("K1", ct.trace_cuda, ct.trace_walk_plain, sl, 37),
        ("K2", ct.occluded_cuda, ct.occluded_walk_plain, short, 4),
    ):
        got, want = kfn(tables, x), wfn(tables, x)
        torch.cuda.synchronize()
        equal = (got[:rows] == want[:rows]).all(0)
        share = equal.float().mean().item()
        log(f"phase {phase}: {name} vs plain walk, {label}: N={x.shape[1]} rows 0-{rows - 1} "
            f"equal on {share:.6f} of lanes ({int((~equal).sum().item())} differ), "
            f"visits/steps/tests per lane {[round(v, 3) for v in want[rows - 3:rows].mean(1).tolist()]}")
        if share < 0.9999:
            raise AssertionError(f"{name} vs plain walk, {label}: {share:.6f} of lanes equal (< 0.9999)")
        shares.append(share)
    return min(shares)


def simt_efficiency(torch, row) -> float:
    """Mean per lane of a per-ray work count over the mean across warps (32
    consecutive lanes) of the warp's maximum: the share of a warp's lane
    slots that did work, when the warp runs as long as its busiest lane."""
    x = row.double()
    warps = torch.nn.functional.pad(x, (0, (-x.shape[0]) % 32)).view(-1, 32)
    peak = warps.max(1).values.mean().item()
    return x.mean().item() / peak if peak > 0 else 1.0


def trace_registers(ptxas: str) -> dict:
    """{instance: (registers, spill-store bytes)} of the trace kernels from
    ptxas's report: K1 (nearest_kernel<true>), its lab instance without the
    winner fetch (nearest_kernel<false>) and K2 (empty when nothing was
    compiled)."""
    names = {"nearest_kernelILb1E": "K1", "nearest_kernelILb0E": "K1 nofetch",
             "any_hit_kernel": "K2"}
    found, cur = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry" in line:
            cur = next((v for k, v in names.items() if k in line), None)
            continue
        if cur is None:
            continue
        regs, spill = found.get(cur, (0, 0))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
        found[cur] = (regs, spill)
    return found


def k3_registers(ptxas: str) -> dict:
    """{B: (registers, spill-store bytes)} of K3's instances from ptxas's
    report, the most over the sampler instances (empty when nothing was
    compiled)."""
    found, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"megakernelILi(\d)ELi(\d)E", line)
        if "Compiling entry" in line:
            cur = int(m.group(2)) if m else None
            continue
        if cur is None:
            continue
        regs, spill = found.get(cur, (0, 0))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = max(spill, int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = max(regs, int(m.group(1)))
        found[cur] = (regs, spill)
    return found


def li_lanes(torch, scene, static):
    """Per-lane radiance of sample pass 0 (the render pass before the splat),
    through the route render() takes for the scene."""
    from kazen_tpu_torch.integrate.render import li_fn_for, sampler_spec

    spec = sampler_spec(static, scene.device)
    stream, rays = camera_rays(torch, scene, static, spec)
    return li_fn_for(static)(scene, static, spec, stream, rays)[1:]


def timed(torch, fn):
    """(fn(), ms of that one call timed with CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_li(torch, got, want, label, phase, lane_gate=True):
    """PERF.md's gate on two (li (N, 3), rays) pairs: per-lane radiance within
    rtol 1e-3 / atol 1e-4 on >= 99% of lanes, channel means within 0.5%,
    ray totals within 0.1% (two images compare as li with rays None).
    ``lane_gate=False`` logs the lane share without holding it (whitted
    between two arithmetic paths: see phase 12). Returns (max abs err over
    all lanes, lane share)."""
    (li_a, rays_a), (li_b, rays_b) = got, want
    li_a, li_b = li_a.float().cpu().reshape(-1, 3), li_b.float().cpu().reshape(-1, 3)
    if rays_a is None:
        rays_a = rays_b = 0.0
    rays_a, rays_b = float(rays_a), float(rays_b)  # numbers or 0-d tensors
    share = torch.isclose(li_a, li_b, rtol=1e-3, atol=1e-4).all(-1).float().mean().item()
    m_a, m_b = li_a.double().mean(0), li_b.double().mean(0)
    rel_mean = ((m_a - m_b).abs() / m_b.abs().clamp(min=1e-12)).max().item()
    rel_rays = abs(rays_a - rays_b) / max(rays_b, 1.0)
    err = (li_a - li_b).abs().max().item()
    log(f"phase {phase}: {label}: N={li_a.shape[0]} {share:.6f} of lanes agree, max abs "
        f"err {err:.3g}, channel means {[round(x, 6) for x in m_a.tolist()]} vs "
        f"{[round(x, 6) for x in m_b.tolist()]} (max rel {rel_mean:.3g}), rays {rays_a:.0f} "
        f"vs {rays_b:.0f} (rel {rel_rays:.3g})")
    if not bool(torch.isfinite(li_a).all()):
        raise AssertionError(f"phase {phase}: {label}: non-finite radiance")
    if lane_gate and share < 0.99:
        raise AssertionError(f"phase {phase}: {label}: only {share:.5f} of lanes agree (< 0.99)")
    if rel_mean > 0.005:
        raise AssertionError(f"phase {phase}: {label}: channel means differ by {rel_mean:.4g}")
    if rel_rays > 0.001:
        raise AssertionError(f"phase {phase}: {label}: ray totals differ by {rel_rays:.4g}")
    return err, share


def k3_variants(torch, mk, sc, st, o, d, stream, ref, label, smi):
    """K3 on one launch's input under every schedule (refill 0, 1) x
    instance B: ms per launch (mean of 5, in turns: forward, then back),
    registers, local bytes and resident blocks, lane-slot efficiency, and
    rows 4-5 totals, which must equal those of ``ref`` (the wrapper's own
    launch on the same input)."""
    keys = [(r, b) for r in (0, 1) for b in mk.MIN_BLOCKS_CHOICES]
    totals = (ref[4].double().sum().item(), ref[5].double().sum().item())
    res = {}
    for refill, b in keys:
        slots = torch.zeros(2, dtype=torch.int64, device=o.device)
        out = mk.megakernel_cuda(sc.mega, st.mega_cfg, o, d, stream, refill, b, slots)
        got = (out[4].double().sum().item(), out[5].double().sum().item())
        if got != totals:
            raise AssertionError(f"phase 9: {label} refill {refill} B={b}: rows 4-5 totals {got} "
                                 f"!= {totals}")
        iters, live = slots.tolist()
        res[(refill, b)] = dict(mk.kernel_info(sc.mega, st.mega_cfg, b),
                                lane_slot_efficiency=live / iters, ms=[])
    for order in (keys, keys[::-1]):
        for refill, b in order:
            res[(refill, b)]["ms"].append(cuda_ms(torch, lambda: mk.megakernel_cuda(
                sc.mega, st.mega_cfg, o, d, stream, refill, b), 5))
    out = {}
    for (refill, b), v in res.items():
        v["ms_turns"] = v["ms"]
        v["ms"] = float(np.mean(v["ms"]))
        out[f"refill {refill} B={b}"] = v
        log(f"phase 9: {label} K3 refill {refill} B={b}: {v['ms']:.4f} ms per launch "
            f"({v['ms_turns'][0]:.4f}, {v['ms_turns'][1]:.4f}), {v['regs']} registers, "
            f"{v['local_bytes']} local bytes, {v['blocks_per_sm']} blocks per SM, lane-slot "
            f"efficiency {v['lane_slot_efficiency']:.4f} [{smi}]")
    log(f"phase 9: {label} rows 4-5 totals equal across all {len(keys)} variants: "
        f"{totals[0]:.0f} tests, {totals[1]:.0f} bounces; row 5's SIMT efficiency (the lane-slot "
        f"figure of one lane a thread) {simt_efficiency(torch, ref[5]):.4f}")
    return out


def device_times(torch, fn):
    """One call of ``fn`` (after a warm-up call) under torch.profiler: (wall
    ms, {kernel name: (device ms, launches)}). The session's raw events are
    read as they are (kazen_tpu_torch.lab.device_activities): parsing them
    into FunctionEvents (``prof.events()``) takes ~60 us an event, seconds
    for a pass of tens of thousands of launches."""
    from torch.profiler import ProfilerActivity, profile

    from kazen_tpu_torch.lab import device_activities

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in device_activities(prof.profiler.kineto_results.events()):
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return wall_ms, by_name


def profile_pass(torch, fn, out_dir, name, top=15):
    """One call of ``fn`` under torch.profiler: wall ms, the device time
    summed over every kernel, and the kernels that take the most of it."""
    wall_ms, by_name = device_times(torch, fn)
    device_ms = sum(ms for ms, _ in by_name.values())
    trace_ms = sum(ms for k, (ms, _) in by_name.items()
                   if "nearest_kernel" in k or "any_hit_kernel" in k)
    mega_ms = sum(ms for k, (ms, _) in by_name.items() if "megakernel" in k)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(os.path.join(out_dir, f"chip_smoke_profile_{name}.txt"), "w") as f:
        for name, (ms, n) in ranked:
            f.write(f"{ms:10.3f} ms {n:6d}x  {name}\n")
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "trace_kernel_ms": trace_ms,
        "megakernel_ms": mega_ms,
        "kernel_launches": sum(n for _, n in by_name.values()),
        "top": [{"name": n, "device_ms": ms, "count": c} for n, (ms, c) in ranked[:top]],
    }

def full_pass(torch, scene, static, kernels, label, phase, smi, need, out_dir=None):
    """render() at full size: launch counts set to 0 before a warm-up pass
    and read after it (every kernel in ``need`` launched, K3 not), the image
    checked (finite, mean > 0), then three passes timed with CUDA events;
    with ``out_dir``, one more pass under torch.profiler."""
    from kazen_tpu_torch.integrate.render import render

    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    img = render(scene, static, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    if any(counts[name] <= 0 for name in need) or counts["K3"]:
        raise AssertionError(f"phase {phase}: {label}: launches {counts}, wanted {need} and no K3")
    if not bool(torch.isfinite(img).all()) or not img.mean().item() > 0.0:
        raise AssertionError(f"phase {phase}: {label}: image not finite with mean > 0")
    ms = cuda_ms(torch, lambda: render(scene, static, device="cuda"), 3)
    log(f"phase {phase}: {label} {static.width}x{static.height} pass {ms:.2f} ms (mean of 3, "
        f"CUDA events; warm-up {warm_s * 1e3:.1f} ms host clock), launches K1 {counts['K1']}, "
        f"K2 {counts['K2']}, image mean {img.mean().item():.5f} [{smi}]")
    out = {"pass_ms": ms, "warm_ms": warm_s * 1e3, "launches": counts,
           "image_mean": img.mean().item(), "width": static.width, "height": static.height}
    if out_dir is not None:
        name = re.sub(r"\W+", "_", label.lower()).strip("_")
        prof = profile_pass(torch, lambda: render(scene, static, device="cuda"), out_dir, name)
        log(f"phase {phase}: {label} profiled pass {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.3f}), trace kernels "
            f"{prof['trace_kernel_ms']:.2f} ms, {prof['kernel_launches']} launches [{smi}]")
        for row in prof["top"][:5]:
            log(f"  {row['device_ms']:9.3f} ms {row['count']:6d}x  {row['name'][:90]}")
        out["profile"] = prof
    return out


# ---------------------------------------------------------------------------
# phases 14-16: gradients, the file front end, the distributed layer
# ---------------------------------------------------------------------------

KISS_MATERIAL = 6  # the stand-in's sphere: the 7th mesh's material row
INVERSE_SIZES = ((1920, 1080), (1440, 810), (960, 540))  # largest first
MEMORY_SHARE = 0.85  # of the card's memory a predicted step peak may take


def leaf_grads(torch, scene, static, keys, target, loss_fn=None):
    """{field: gradient on the CPU} of mean((img - target)^2) (or
    ``loss_fn(img)``) over the parameter groups ``keys``, through one sample
    pass (sample 0) of the route diff/inverse.py runs."""
    from kazen_tpu_torch.diff import inverse as inv
    from kazen_tpu_torch.integrate.render import sampler_spec

    params = inv.as_leaves(inv.get_params(scene, keys))
    img = inv.render_image(scene, static, sampler_spec(static, scene.device), params, [0])
    loss = inv.image_loss(img, target) if loss_fn is None else loss_fn(img)
    loss.backward()
    flat = dict(params.get("materials", {}))
    flat.update({k: v for k, v in params.items() if k != "materials"})
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad).detach().cpu()
            for k, v in flat.items()}


def check_grads(torch, got, want, label, phase):
    """(a)'s gate per field: allclose(rtol=1e-3, atol=1e-3 * max|want|).
    Returns the largest |got - want| / (atol + rtol |want|) over fields."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        atol = 1e-3 * w.abs().max().item()
        ratio = ((g - w).abs() / (atol + 1e-3 * w.abs()).clamp(min=1e-30)).max().item()
        worst = max(worst, ratio)
        if not torch.allclose(g, w, rtol=1e-3, atol=atol):
            raise AssertionError(f"phase {phase}: {label}: gradient of {k} differs: max |g - w| "
                                 f"{(g - w).abs().max().item():.3g}, max |w| {w.abs().max().item():.3g}")
    nonzero = sorted(k for k, w in want.items() if w.abs().max().item() > 0)
    log(f"phase {phase}: {label}: {len(want)} fields within rtol 1e-3 / atol 1e-3 max|g| "
        f"(worst {worst:.3g} of the limit); nonzero: {nonzero}")
    return worst


def smoke_target(torch, scene, static):
    """A seeded (H, W, 3) target image on the scene's device."""
    return torch.as_tensor(
        0.3 * np.random.RandomState(SEED).rand(static.height, static.width, 3).astype(np.float32),
        device=scene.device)


@contextlib.contextmanager
def plain_walks(ct):
    """CPU tensors trace through the plain walks (which K1/K2 equal bit for
    bit) in place of the brute-force plain versions."""
    saved = ct.trace_plain, ct.occluded_plain
    ct.trace_plain, ct.occluded_plain = ct.trace_walk_plain, ct.occluded_walk_plain
    try:
        yield
    finally:
        ct.trace_plain, ct.occluded_plain = saved


@contextlib.contextmanager
def indexing_gathers():
    """Material rows gathered by indexing, ``table[idx]``, whose backward
    sorts the lanes' ids (the first form of MaterialTable.rows; for the
    comparison in phase 14c only)."""
    from kazen_tpu_torch.scene.compiler import MaterialTable

    saved = MaterialTable.rows
    MaterialTable.rows = lambda self, idx: MaterialTable(
        **{f.name: getattr(self, f.name)[idx] for f in dataclasses.fields(self)})
    try:
        yield
    finally:
        MaterialTable.rows = saved


def timed_step(torch, scene, static):
    """One forward + backward of an optimize step (sample 0, zero target,
    the material table): (forward ms, backward ms, peak bytes), by CUDA
    events."""
    from kazen_tpu_torch.diff import inverse as inv
    from kazen_tpu_torch.integrate.render import sampler_spec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    params = inv.as_leaves(inv.get_params(scene, ("materials",)))
    ev[0].record()
    img = inv.render_image(scene, static, sampler_spec(static, scene.device), params, [0])
    loss = inv.image_loss(img, torch.zeros_like(img))
    ev[1].record()
    loss.backward()
    ev[2].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), torch.cuda.max_memory_allocated()


def phase_gradients(torch, D, kernels, smi, out_dir):
    """Phase 14: gradients on the card (a-d)."""
    from kazen_tpu_torch.accel import cluster_trace as ct
    from kazen_tpu_torch.diff import inverse as inv
    from kazen_tpu_torch.integrate.render import sampler_spec
    from kazen_tpu_torch.scene.compiler import compile_scene

    out = {}
    # (a) AD on the card (K1/K2) against AD on the CPU (the plain walks)
    t0 = time.time()
    small = stand_in_scene(D, SMALL_W, SMALL_H)
    keys = ("materials", "light_radiance", "bg_color")
    card = compile_scene(small, device="cuda")
    cpu = compile_scene(small, device="cpu")
    g_card = leaf_grads(torch, *card, keys, smoke_target(torch, *card))
    with plain_walks(ct):
        g_cpu = leaf_grads(torch, *cpu, keys, smoke_target(torch, *cpu))
    out["stand_in_worst"] = check_grads(torch, g_card, g_cpu, f"stand-in {SMALL_W}x{SMALL_H} "
                                        "gradients, card vs CPU", 14)
    out["stand_in_card_grads"] = g_card
    small = textured_scene(D, SMALL_W, SMALL_H)
    card_t = compile_scene(small, device="cuda")
    cpu_t = compile_scene(small, device="cpu")
    g_card = leaf_grads(torch, *card_t, ("texels",), smoke_target(torch, *card_t))
    with plain_walks(ct):
        g_cpu = leaf_grads(torch, *cpu_t, ("texels",), smoke_target(torch, *cpu_t))
    out["textured_worst"] = check_grads(torch, g_card, g_cpu, f"Textured {SMALL_W}x{SMALL_H} "
                                        "texel gradients, card vs CPU", 14)
    out["a_s"] = time.time() - t0
    log(f"phase 14a: {out['a_s']:.1f} s")

    # (b) FD against AD at full width, depth 2 (tests/test_grad.py's criterion)
    t0 = time.time()
    sc, st = compile_scene(stand_in_scene(D, WIDTH, HEIGHT, depth=2), device="cuda")
    spec = sampler_spec(st, sc.device)

    def mean_loss(img):
        return img.double().mean()

    ad = leaf_grads(torch, sc, st, ("materials",), None, mean_loss)["base_color"]
    base = sc.materials.base_color
    h = 1e-3
    fd_rows = []
    for mi, ch in ((0, 0), (KISS_MATERIAL, 1)):
        vals = []
        for sign in (1.0, -1.0):
            bc = base.clone()
            bc[mi, ch] += sign * h
            with torch.no_grad():
                img = inv.render_image(sc, st, spec, {"materials": {"base_color": bc}}, [0])
            vals.append(mean_loss(img).item())
        fd = (vals[0] - vals[1]) / (2 * h)
        a = ad[mi, ch].item()
        ok = abs(fd - a) <= 2e-3 * max(abs(fd), abs(a), 1e-3)
        log(f"phase 14b: base_color[{mi}, {ch}] at {WIDTH}x{HEIGHT} depth 2: FD {fd:.6g}, AD "
            f"{a:.6g}, rel diff {abs(fd - a) / max(abs(fd), abs(a), 1e-3):.3g} (limit 2e-3)")
        if not ok:
            raise AssertionError(f"phase 14b: FD {fd} vs AD {a} on base_color[{mi}, {ch}]")
        fd_rows.append({"material": mi, "channel": ch, "fd": fd, "ad": a})
    out["fd_vs_ad"] = fd_rows
    del sc, st
    log(f"phase 14b: {time.time() - t0:.1f} s")

    # (c) optimize at full width: the kiss sphere's base_color and roughness
    # from wrong values, against a target at the true values, sample 0
    t0 = time.time()
    total = torch.cuda.get_device_properties(0).total_memory
    probe_w, probe_h = INVERSE_SIZES[-1]
    sc, st = compile_scene(stand_in_scene(D, probe_w, probe_h), device="cuda")
    timed_step(torch, sc, st)  # warm-up: the allocator's pool grows
    # the gathers of the material table by index_select against indexing,
    # in turns: the backward's ms of each
    gathers = {"index_select": [], "indexing": []}
    for name in ("index_select", "indexing", "indexing", "index_select"):
        with indexing_gathers() if name == "indexing" else contextlib.nullcontext():
            fwd_, bwd_, peak_ = timed_step(torch, sc, st)
        gathers[name].append(bwd_)
        if name == "index_select":
            peak_probe = peak_
    log(f"phase 14c: {probe_w}x{probe_h} step backward ms, material rows by index_select "
        f"{gathers['index_select']} vs by indexing {gathers['indexing']} (in turns) [{smi}]")
    out["gathers_backward_ms"] = gathers
    del sc, st
    width, height = probe_w, probe_h
    for w_, h_ in INVERSE_SIZES:
        if peak_probe * (w_ * h_) / (probe_w * probe_h) < MEMORY_SHARE * total:
            width, height = w_, h_
            break
    log(f"phase 14c: step peak {peak_probe / 1e9:.2f} GB at {probe_w}x{probe_h}; the card "
        f"holds {total / 1e9:.1f} GB; the step runs at {width}x{height}")
    true_sc, st = compile_scene(stand_in_scene(D, width, height), device="cuda")
    spec = sampler_spec(st, true_sc.device)
    with torch.no_grad():
        target = inv.render_image(true_sc, st, spec, {}, [0])
    bc = true_sc.materials.base_color.clone()
    rough = true_sc.materials.roughness.clone()
    bc[KISS_MATERIAL] = torch.tensor([0.3, 0.3, 0.3], device=bc.device)
    rough[KISS_MATERIAL] = 0.6
    start = dataclasses.replace(true_sc, materials=dataclasses.replace(
        true_sc.materials, base_color=bc, roughness=rough))
    def one_step():
        p = inv.as_leaves(inv.get_params(start, ("materials",)))
        inv.image_loss(inv.render_image(start, st, spec, p, [0]), target).backward()

    one_step()  # warm-up: the allocator's pool grows to the step's peak
    # one instrumented step: forward and backward apart, launches of each
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    params = inv.as_leaves(inv.get_params(start, ("materials",)))
    ev[0].record()
    loss = inv.image_loss(inv.render_image(start, st, spec, params, [0]), target)
    ev[1].record()
    fwd_counts = {name: k.launches for name, k in kernels.items()}
    loss.backward()
    ev[2].record()
    torch.cuda.synchronize()
    bwd_counts = {name: k.launches - fwd_counts[name] for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    del params, loss
    if fwd_counts["K1"] <= 0 or fwd_counts["K2"] <= 0 or fwd_counts["K3"]:
        raise AssertionError(f"phase 14c: forward launches {fwd_counts}")
    if any(bwd_counts.values()):
        raise AssertionError(f"phase 14c: the backward launched {bwd_counts}")
    prof = profile_pass(torch, one_step, out_dir, "inverse_step")
    # five optimize steps through the entry point
    steps = 5
    for k in kernels.values():
        k.launches = 0
    s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s_ev.record()
    res = inv.optimize(start, st, target, param_keys=("materials",), steps=steps,
                       learning_rate=0.05)
    e_ev.record()
    torch.cuda.synchronize()
    step_ms = s_ev.elapsed_time(e_ev) / steps
    counts = {name: k.launches for name, k in kernels.items()}
    if counts != {name: steps * n for name, n in fwd_counts.items()}:
        raise AssertionError(f"phase 14c: {steps} steps launched {counts}, forward alone "
                             f"{fwd_counts} a step")
    losses = [float(x) for x in res.losses]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"phase 14c: losses did not fall: {losses}")
    got = res.params["materials"]
    log(f"phase 14c: optimize {width}x{height} depth {DEPTH}, {steps} steps: {step_ms:.1f} ms per "
        f"step (CUDA events); one step: forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, device "
        f"{prof['device_ms']:.1f} ms in {prof['kernel_launches']} launches (busy "
        f"{prof['busy_share']:.3f}), peak memory {peak / 1e9:.2f} GB [{smi}]")
    log(f"phase 14c: launches per step K1 {fwd_counts['K1']}, K2 {fwd_counts['K2']}, K3 "
        f"{fwd_counts['K3']} (forward), backward {bwd_counts}; losses {[f'{x:.6g}' for x in losses]}; "
        f"kiss base_color {[round(v, 4) for v in got['base_color'][KISS_MATERIAL].tolist()]}, "
        f"roughness {got['roughness'][KISS_MATERIAL].item():.4f} (true 0.6 0.4 0.8 / 0.3)")
    for row in prof["top"][:5]:
        log(f"  {row['device_ms']:9.3f} ms {row['count']:6d}x  {row['name'][:90]}")
    out["inverse"] = {
        "width": width, "height": height, "depth": DEPTH, "steps": steps, "ms_per_step": step_ms,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms, "device_ms_per_step": prof["device_ms"],
        "launches_per_step": prof["kernel_launches"], "busy_share": prof["busy_share"],
        "peak_bytes": peak, "probe_peak_bytes": peak_probe, "probe_size": [probe_w, probe_h],
        "losses": losses, "forward_launches": fwd_counts, "backward_launches": bwd_counts,
        "top": prof["top"],
    }
    del true_sc, start, target, res
    torch.cuda.empty_cache()
    log(f"phase 14c: {time.time() - t0:.1f} s")

    # (d) K3's class: a Mixed scene compiled for the card takes the
    # megakernel in render(), but diff/ must run the wavefront
    t0 = time.time()
    mixed = mixed_scene(D, 320, 180)
    on = compile_scene(mixed, device="cuda")
    off = compile_scene(mixed, device="cuda", megakernel=False)
    if not on[1].use_megakernel or off[1].use_megakernel:
        raise AssertionError("phase 14d: Mixed must take the megakernel unless told not to")
    for k in kernels.values():
        k.launches = 0
    g_on = leaf_grads(torch, *on, ("materials",), smoke_target(torch, *on))
    inv.optimize(on[0], on[1], smoke_target(torch, *on), steps=1)
    torch.cuda.synchronize()
    if kernels["K3"].launches or not kernels["K1"].launches:
        raise AssertionError(f"phase 14d: launches {[(n, k.launches) for n, k in kernels.items()]}")
    g_off = leaf_grads(torch, *off, ("materials",), smoke_target(torch, *off))
    check_grads(torch, g_on, g_off, "Mixed 320x180 compiled with K3 on vs off (K3 launched 0 "
                "times)", "14d")
    if not g_on["base_color"].abs().max().item() > 0:
        raise AssertionError("phase 14d: the gradient is zero")
    log(f"phase 14d: {time.time() - t0:.1f} s")
    return out


def encode_png8(path, rgb8):
    """A minimal 8-bit RGB PNG writer (every row filter 0)."""
    import struct
    import zlib

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    h, w = rgb8.shape[:2]
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_obj(path, mesh):
    """An inline mesh as OBJ: v/vt/vn with floats printed %.9g (float32
    round-trips exactly), faces with one index for all three."""
    def rows(tag, a):
        return "".join(f"{tag} " + " ".join("%.9g" % x for x in r) + "\n" for r in a)

    with open(path, "w") as f:
        f.write(rows("v", mesh.vertices))
        f.write(rows("vt", mesh.uvs))
        f.write(rows("vn", mesh.normals))
        f.write("".join("f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in face) + "\n"
                        for face in mesh.faces))


def _xml_color(name, c):
    return f'<color name="{name}" value="{" ".join(repr(float(x)) for x in c)}"/>'


def write_scene_xml(D, desc, out_dir):
    """The file-front-end stand-in: one OBJ per mesh and a scene XML."""
    meshes = []
    for i, m in enumerate(desc.meshes):
        write_obj(os.path.join(out_dir, f"mesh{i}.obj"), m)
        b = m.bsdf
        if isinstance(b, D.Diffuse):
            bsdf = f'<bsdf type="diffuse">{_xml_color("albedo", b.albedo)}</bsdf>'
        else:
            bsdf = (f'<bsdf type="kazenstandard"><texture type="imagetexture" id="baseColor">'
                    f'<string name="filename" value="{b.base_color.filename}"/></texture>'
                    f'<texture type="constanttexture" id="metallic">'
                    f'{_xml_color("color", (b.metallic,) * 3)}</texture>'
                    f'<texture type="constanttexture" id="roughness">'
                    f'{_xml_color("color", (b.roughness,) * 3)}</texture></bsdf>')
        light = ""
        if m.light is not None:
            light = (f'<light type="area">{_xml_color("color", m.light.color)}'
                     f'<float name="intensity" value="{m.light.intensity!r}"/></light>')
        meshes.append(f'<mesh type="obj"><string name="filename" value="mesh{i}.obj"/>'
                      f'{bsdf}{light}</mesh>')
    cam = desc.camera
    bg = desc.background
    xml = f"""<?xml version="1.0"?>
<scene>
  <integrator type="path_mis"><integer name="maxDepth" value="{desc.integrator.max_depth}"/></integrator>
  <sampler type="{desc.sampler.kind}"><integer name="sampleCount" value="{desc.sampler.sample_count}"/>
    <integer name="seed" value="{desc.sampler.seed}"/></sampler>
  <camera type="perspective">
    <integer name="width" value="{cam.width}"/><integer name="height" value="{cam.height}"/>
    <float name="fov" value="{cam.fov!r}"/>
    <transform name="toWorld"><lookat origin="0, 1, -2.5" target="0, 1, 0" up="0, 1, 0"/></transform>
    <rfilter type="{desc.rfilter.kind}"/>
  </camera>
  {chr(10).join(meshes)}
  <texture type="background" id="background">
    <texture type="imagetexture"><string name="filename" value="{bg.texture.filename}"/>
      <string name="colorspace" value="linear"/></texture>
    <float name="intensity" value="{bg.intensity!r}"/>
  </texture>
</scene>
"""
    path = os.path.join(out_dir, "stand_in.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


def files_scene(D, width, height, base, sky):
    """The stand-in whose kiss sphere has an sRGB baseColor image and whose
    background is a lat-long sky: ``base`` and ``sky`` are ImageTextures'
    file names, or data arrays."""
    def tex(x, **kw):
        return D.ImageTexture(filename=x, **kw) if isinstance(x, str) else D.ImageTexture(
            data=x, **kw)

    desc = stand_in_scene(D, width, height)
    sphere = desc.meshes[-1]
    desc.meshes[-1] = dataclasses.replace(sphere, bsdf=D.KazenStandard(
        base_color=tex(base), metallic=0.3, roughness=0.3))
    desc.background = D.Background(texture=tex(sky, colorspace="linear"), intensity=1.0)
    return desc


def phase_files(torch, D, smi, work_dir):
    """Phase 15: the stand-in written as OBJ + XML with a PNG baseColor and
    an EXR sky, rendered through render_resumable and the CLI, against the
    same description built in memory from the decoded arrays."""
    from kazen_tpu_torch.cli.main import main as cli_main
    from kazen_tpu_torch.film import checkpoint
    from kazen_tpu_torch.film.io import load_exr, save_exr
    from kazen_tpu_torch.integrate.render import render
    from kazen_tpu_torch.scene.compiler import compile_scene, read_texture_file
    from kazen_tpu_torch.scene.xml_io import load_xml

    times = {}
    t0 = time.time()
    rng = np.random.RandomState(SEED)
    png = os.path.join(work_dir, "base.png")
    encode_png8(png, np.round(kiss_base_image(rng) * 255.0).astype(np.uint8))
    sky = 0.08 + 0.04 * rng.rand(256, 512, 3).astype(np.float32)
    sky[64:80, 160:184] = (1.4, 1.3, 1.1)  # below the 1.5 at which a file is read as 8-bit
    exr = os.path.join(work_dir, "sky.exr")
    save_exr(exr, sky, compression="zip")
    written = files_scene(D, WIDTH, HEIGHT, "base.png", "sky.exr")
    xml = write_scene_xml(D, written, work_dir)
    times["write_s"] = time.time() - t0

    t0 = time.time()
    desc = load_xml(xml)
    scene, static = compile_scene(desc, device="cuda")
    times["load_compile_s"] = time.time() - t0
    n_faces = sum(len(m.faces) for m in written.meshes)
    if int(scene.F.shape[0]) != n_faces or not static.has_image_textures:
        raise AssertionError(f"phase 15: the file scene has {int(scene.F.shape[0])} faces, "
                             f"not {n_faces}, or no image texture")
    ck = os.path.join(work_dir, "ck.npz")
    t0 = time.time()
    checkpoint.render_resumable(scene, static, spp=1, checkpoint_path=ck, checkpoint_every=1)
    torch.cuda.synchronize()
    times["resumable_s"] = time.time() - t0
    if checkpoint.load(ck)[1] != 1:
        raise AssertionError("phase 15: the checkpoint does not stand at sample 1")
    out_exr = os.path.join(work_dir, "out.exr")
    t0 = time.time()
    cli_main([xml, "-o", out_exr, "--spp", "2", "--checkpoint", ck])
    times["cli_s"] = time.time() - t0
    got = torch.from_numpy(load_exr(out_exr))
    mem = files_scene(D, WIDTH, HEIGHT, read_texture_file(png), read_texture_file(exr))
    want = render(*compile_scene(mem, device="cuda"), spp=2, device="cuda").cpu()
    err, share = check_li(torch, (got, None), (want, None), "file scene through render_resumable "
                          "and the CLI (2 spp) vs the in-memory description", 15)
    equal = (got == want).all(-1).float().mean().item()
    log(f"phase 15: {equal:.6f} of pixels equal bit for bit; write {times['write_s']:.2f} s, "
        f"load + compile {times['load_compile_s']:.2f} s, render_resumable (1 spp) "
        f"{times['resumable_s']:.2f} s, CLI resume to 2 spp {times['cli_s']:.2f} s [{smi}]")
    return dict(times, max_abs_err=err, share=share, equal=equal, xml=xml)


def phase_distributed(torch, D, smi, scene, static, xml, grad_ref, work_dir):
    """Phase 16: dist/ in a process group of one on nccl."""
    import torch.distributed as dist

    from kazen_tpu_torch.cli.main import main as cli_main
    from kazen_tpu_torch.dist.multihost import free_port
    from kazen_tpu_torch.dist.sharding import inverse_train_step, render_distributed
    from kazen_tpu_torch.film.io import load_png
    from kazen_tpu_torch.integrate.render import pixel_grid, render, sampler_spec
    from kazen_tpu_torch.core import rng
    from kazen_tpu_torch.scene.compiler import compile_scene

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    log(f"phase 16: process group of {dist.get_world_size()} on {dist.get_backend()}")
    img_d = render_distributed(scene, static, spp=1)
    err, share = check_li(torch, (img_d, None), (render(scene, static, device="cuda"), None),
                          "render_distributed (scatter splat) vs render() at 1080p", 16)
    sc, st = compile_scene(stand_in_scene(D, SMALL_W, SMALL_H), device="cuda")
    px, py = pixel_grid(st, sc.device)
    step = inverse_train_step(sc, st, sampler_spec(st, sc.device))
    _, grads = step(sc, smoke_target(torch, sc, st), px, py, 0, rng.advance_constants(0))
    check_grads(torch, {k: v.cpu() for k, v in grads.items()},
                {k: v for k, v in grad_ref.items() if k in grads},
                "inverse_train_step vs phase 14's single-process gradient", 16)
    out_png = os.path.join(work_dir, "dist.png")
    cli_main([xml, "-o", out_png, "--spp", "1", "--distributed"])
    if load_png(out_png).shape != (HEIGHT, WIDTH, 3):
        raise AssertionError("phase 16: the CLI's distributed render wrote no 1080p image")
    dist.destroy_process_group()
    return {"max_abs_err": err, "share": share}


# ---------------------------------------------------------------------------
# phase 17: the lab probes K4-K6
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores (NVIDIA data sheet)
# f32 operations of one acceptance chain, det to tt, as lab/csrc/lab.cu
# writes it: the sign's select, four products by it, three subtractions,
# four minima, two compares, the reciprocal, its product and tt's select;
# K5 adds tt + r and its running minimum
CHAIN_FLOPS = 17
K5_LAUNCHES = 21  # single launches whose median device time is K5's
REPS_SHORT = 64  # K4 at 512 reps must take >= REPS_SCALING x its time at 64
REPS_SCALING = 6.0


def mm_has_out_dtype(torch) -> bool:
    """Whether this torch's torch.mm takes out_dtype (bf16 operands, f32
    result) on the card."""
    a = torch.ones((64, 64), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return True


def library_mm(torch, w, f, reps, kind, out_dtype):
    """K4's yardstick, never called by the port: the sum over reps of W^T f
    as PyTorch computes it, reps x (torch.mm + add_), f32 operands with TF32
    off for HIGHEST, bf16 operands otherwise (f32 products where torch.mm
    takes out_dtype, else its bf16 result cast to f32)."""
    a, b = w.t(), f
    if kind != "HIGHEST":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    mm = ((lambda: torch.mm(a, b, out_dtype=torch.float32)) if kind != "HIGHEST" and out_dtype
          else (lambda: torch.mm(a, b).to(torch.float32)))

    def run():
        acc = torch.zeros((w.shape[1], f.shape[1]), dtype=torch.float32, device=w.device)
        for _ in range(reps):
            acc.add_(mm())
        return acc

    return run


def drain_design(precision, bf16) -> str:
    """K6's design for a precision and geo type, as kz_drain_probe picks it:
    rounded (bf16) operands on the tensor cores, f32 ones on the CUDA cores."""
    return "wgmma bf16" if precision == "DEFAULT" or bf16 else "simt f32"


def lab_check_geo(torch, qp, kt, bf16, dev):
    """K6's check input: seeded, uniform in [-1, 1] for qp = 4 and in
    [-5, -1] for qp = 1, where the quantities are D, D+16, D+32, D+48 (D a
    sum of 16 values) and a test is accepted only for D in [-80, -48]."""
    from kazen_tpu_torch.lab import visit_lab

    lo, hi = (-1.0, 1.0) if qp == 4 else (-5.0, -1.0)
    g = np.random.default_rng(SEED).uniform(lo, hi, visit_lab.geo_shape(qp, kt))
    return torch.from_numpy(g.astype(np.float32)).to(dev, torch.bfloat16 if bf16 else torch.float32)


def lab_registers(ptxas: str) -> dict:
    """{kernel instance: (registers, spill-store bytes)} of lab/csrc/lab.cu
    from ptxas's report (empty when nothing was compiled)."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16"}
    found, cur = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(mm_kernel|chain_kernel|drain_simt_kernel|drain_tc_kernel)"
                          r"(?:I(\w*?)E)?E", line)
            cur = None
            if m:
                args = [n or types[t] for n, t in
                        re.findall(r"Li(\d+)|(13__nv_bfloat16|f)", m.group(2) or "")]
                cur = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            continue
        if cur is None:
            continue
        regs, spill = found.get(cur, (0, 0))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
        found[cur] = (regs, spill)
    return found


def lab_int_geo(torch, qp, kt, bf16, dev):
    """K6's layout check input: seeded integers in [-8, 8], so every product
    and every sum over the F rows is exact in bf16 and f32, in any order."""
    from kazen_tpu_torch.lab import visit_lab

    g = np.random.default_rng(SEED).integers(-8, 9, visit_lab.geo_shape(qp, kt))
    return torch.from_numpy(g.astype(np.float32)).to(dev, torch.bfloat16 if bf16 else torch.float32)


def drain_same(torch, got, want):
    """K6's gate: rows, accepted counts and fetches equal, least t within
    rtol 1e-6 (rcp.approx against the exact reciprocal). Returns (ok, which
    are equal, least t's relative error)."""
    diff = (got[2] - want[2]).abs()
    t_err = torch.where(diff == 0, 0.0, diff / want[2].abs()).max().item()  # 0 where both are 0
    same = [torch.equal(x, y) for x, y in zip(got, want)]
    return same[0] and same[1] and same[3] and t_err <= 1e-6, same, t_err


def lab_bound(flops_by_peak, nbytes):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and the operations over their type's peak."""
    t_ops = sum(fl / peak for fl, peak in flops_by_peak) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes > t_ops else "operations"


def phase_lab(torch, smi, ptxas=""):
    """Phase 17: the lab probes K4-K6 (kazen_tpu_torch/lab/) on the card.
    First K6's tensor-core layout check; then their main path, the two
    probes' tables (mxu_lab.main, visit_lab.main), driven with the counts set
    to 0 before and read after; then each kernel against its plain version,
    ms, bound, plain ms and (K4) library ms. ``ptxas`` is the lab library's
    compiler report, for the registers and spills of each instance."""
    from kazen_tpu_torch.lab import launch_device_ms, mxu_lab, visit_lab

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    regs = lab_registers(ptxas)
    for name, (n_regs, spill) in sorted(regs.items()):
        log(f"phase 17: {name}: {n_regs} registers, {spill} bytes of spill stores")
    if any(spill for _, spill in regs.values()):
        raise AssertionError(f"phase 17: a lab kernel spills: {regs}")

    # K6's wgmma layout check: every DEFAULT and bf16 configuration, and K
    # not a multiple of the 64-test chunk, on integer geo (exact sums), 8
    # blocks of 7 visits
    checks = [c[1:] for c in visit_lab.CONFIGS if c[3] == "DEFAULT" or c[4]]
    checks += [(1, 100, "DEFAULT", False, True, True), (4, 36, "DEFAULT", True, True, True)]
    for qp, kt, prec, bf16, fetch, dma in checks:
        geo = lab_int_geo(torch, qp, kt, bf16, dev)
        args = (7, qp, kt, prec, fetch, dma, 8)
        ok, same, t_err = drain_same(torch, visit_lab.drain_cuda(geo, *args, diag=True),
                                     visit_lab.drain_plain(geo, *args, diag=True))
        if not ok:
            raise AssertionError(f"phase 17: K6 layout check qp={qp} K={kt} {prec} bf16={bf16}: "
                                 f"rows/count/tmin/fetches equal {same}, least t rel {t_err}")
    log(f"phase 17: K6's wgmma layout check: {len(checks)} configurations on integer geo in "
        f"[-8, 8]: rows, counts and fetches equal, least t within rtol 1e-6 [{smi}]")

    kernels = {"K4": mxu_lab.MM_PROBE, "K5": mxu_lab.CHAIN_PROBE, "K6": visit_lab.DRAIN_PROBE}
    for k in kernels.values():
        k.launches = 0
    mm_rows, chain_row = mxu_lab.main()
    drain_rows = visit_lab.main()
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"phase 17: the probes' tables launched {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"phase 17: a lab kernel was not launched: {launches}")

    # K4 at every shape of the table, then at K = 8 and 40 (not multiples of
    # 16), M = 128, each precision
    rng = np.random.default_rng(SEED)
    out_dtype = mm_has_out_dtype(torch)
    padded = [{"kind": kind, "M": 128, "K": k, "N": mxu_lab.N, "reps": mxu_lab.REPS}
              for kind in ("HIGHEST", "DEFAULT", "bf16-in") for k in (8, 40)]
    for row in mm_rows + padded:
        kind, m, k, n, reps = row["kind"], row["M"], row["K"], row["N"], row["reps"]
        dt = torch.bfloat16 if kind == "bf16-in" else torch.float32
        w = torch.from_numpy(rng.random((k, m), dtype=np.float32)).to(dev, dt)
        f = torch.from_numpy(rng.random((k, n), dtype=np.float32)).to(dev, dt)
        prec = "HIGHEST" if kind == "HIGHEST" else "DEFAULT"
        if "ms" not in row:
            row["ms"] = cuda_ms(torch, lambda: mxu_lab.mm_probe_cuda(w, f, reps, prec), 5)
        got = mxu_lab.mm_probe_cuda(w, f, reps, prec)
        want = mxu_lab.mm_probe_plain(w, f, reps, prec)
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        if not err <= 1e-5 * top:
            raise AssertionError(f"phase 17: K4 {kind} M={m} K={k}: max abs err {err} > 1e-5 x {top}")
        lib_fn = library_mm(torch, w, f, reps, kind, out_dtype)
        lib_err = (lib_fn() - want).abs().max().item()
        lib_device_ms = sum(ms for ms, _ in device_times(torch, lib_fn)[1].values())
        peak = PEAK_F32_FLOPS if kind == "HIGHEST" else PEAK_BF16_FLOPS
        row.update(max_abs_err=err, rel_err=err / top, library_err=lib_err,
                   library_device_ms=lib_device_ms,
                   plain_ms=cuda_ms(torch, lambda: mxu_lab.mm_probe_plain(w, f, reps, prec), 3),
                   library_ms=cuda_ms(torch, lib_fn, 3))
        row["bound_ms"], row["bound_by"] = lab_bound(
            [(2.0 * m * k * n * reps, peak)], (m + n) * k * w.element_size() + m * n * 4)
        row["tflops"] = 2.0 * m * k * n * reps / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        log(f"phase 17: K4 {kind} M={m} K={k} N={n} reps {reps}: {row['ms']:.4f} ms per launch, "
            f"{row['tflops']:.2f} TFLOP/s, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"{row['bound_share']:.3f} of it), plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms ({lib_device_ms:.3f} ms of device time under "
            f"torch.profiler, max abs err {lib_err:.3g}); kernel max abs err "
            f"{err:.3g} = {err / top:.3g} x max [{smi}]")
        if (m, k) == (1024, 128):
            # each rep computes the product anew: 512 reps cost >= 6x 64 reps
            turns = [cuda_ms(torch, lambda r=r: mxu_lab.mm_probe_cuda(w, f, r, prec), 5)
                     for r in (reps, REPS_SHORT, REPS_SHORT, reps)]
            row["reps_ratio"] = (turns[0] + turns[3]) / (turns[1] + turns[2])
            log(f"phase 17: K4 {kind} M={m} K={k}: {reps} reps / {REPS_SHORT} reps = "
                f"{row['reps_ratio']:.3f} (in turns: {[round(t, 4) for t in turns]} ms) [{smi}]")
            if row["reps_ratio"] < REPS_SCALING:
                raise AssertionError(f"phase 17: K4 {kind}: {reps} reps take only "
                                     f"{row['reps_ratio']:.3f}x {REPS_SHORT} reps")
    log(f"phase 17: K4's yardstick: torch.mm {'with' if out_dtype else 'without'} out_dtype "
        f"(bf16 operands, {'f32' if out_dtype else 'bf16'} products out)")

    # K5 on the original's input (uniform in [0, 1), (512, 1024)) and on the
    # diagnostics' (uniform in [-1, 1), where tests of either sign of det
    # are accepted): outputs and counts equal, least t within rtol 1e-6
    n = chain_row["N"]
    shape = (4 * mxu_lab.CHAIN_ROWS, n)
    inputs = {"original": rng.random(shape, dtype=np.float32),
              "diagnostics": rng.uniform(-1.0, 1.0, shape).astype(np.float32)}
    for label, x in inputs.items():
        a = torch.from_numpy(x).to(dev)
        got = mxu_lab.chain_probe_cuda(a, diag=True)
        want = mxu_lab.chain_probe_plain(a, diag=True)
        diff = (got[2] - want[2]).abs()
        t_err = torch.where(diff == 0, 0.0, diff / want[2].abs()).max().item()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and t_err <= 1e-6):
            raise AssertionError(f"phase 17: K5 differs from its plain version on the {label} "
                                 f"input (least t rel {t_err})")
        chain_row[f"check_{label}"] = {"tmin_rel_err": t_err, "accepted": int(got[1].sum().item())}
    a = torch.from_numpy(inputs["original"]).to(dev)
    # device time a launch (torch.profiler), beside an empty kernel at K5's
    # launch shape (the card's floor for it) and the time a Python call
    # takes (CUDA events over mxu_lab.main's 20 back-to-back calls)
    chain_row["call_ms"] = chain_row.pop("ms")
    chain_row["ms"] = launch_device_ms(lambda: mxu_lab.chain_probe_cuda(a), K5_LAUNCHES)
    chain_row["floor_ms"] = launch_device_ms(lambda: mxu_lab.chain_empty_cuda(a), K5_LAUNCHES)
    chain_row.update(
        max_abs_err=(got[0] - want[0]).abs().max().item(),
        tmin_rel_err=max(c["tmin_rel_err"] for k, c in chain_row.items() if k.startswith("check_")),
        accepted=chain_row["check_original"]["accepted"],
        plain_ms=cuda_ms(torch, lambda: mxu_lab.chain_probe_plain(a), 3))
    chain_row["bound_ms"], chain_row["bound_by"] = lab_bound(
        [(mxu_lab.CHAIN_ROWS * n * mxu_lab.CHAIN_REPS * (CHAIN_FLOPS + 2), PEAK_F32_FLOPS)],
        5 * mxu_lab.CHAIN_ROWS * n * 4)
    us = {k: chain_row[k] * 1e3 for k in ("ms", "floor_ms", "bound_ms")}
    chain_row["meets"] = {"2 x bound": us["ms"] <= 2.0 * us["bound_ms"],
                          "floor + 1 us": us["ms"] <= us["floor_ms"] + 1.0}
    log(f"phase 17: K5 (128x{n}, {mxu_lab.CHAIN_REPS} reps): device {us['ms']:.3f} us a launch "
        f"(torch.profiler, median of {K5_LAUNCHES} launches), empty kernel at its launch shape "
        f"{us['floor_ms']:.3f} us, call {chain_row['call_ms'] * 1e3:.2f} us (CUDA events over 20 "
        f"Python calls); bound {us['bound_ms']:.3f} us ({chain_row['bound_by']}); targets "
        f"{chain_row['meets']}; plain {chain_row['plain_ms']:.3f} ms; outputs and accepted counts "
        f"equal on the original's and the diagnostics' input "
        f"({chain_row['check_original']['accepted']} and "
        f"{chain_row['check_diagnostics']['accepted']} accepted), least t within "
        f"{chain_row['tmin_rel_err']:.3g} [{smi}]")

    # K6 at each configuration: kernel against plain on a seeded geo
    for row in drain_rows:
        qp, kt, bf16 = row["qp"], row["K"], row["bf16"]
        args = (row["visits"], qp, kt, row["precision"], row["fetch"], row["dma"], row["blocks"])
        geo = lab_check_geo(torch, qp, kt, bf16, dev)
        got = visit_lab.drain_cuda(geo, *args, diag=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = visit_lab.drain_plain(geo, *args, diag=True)
        end.record()
        torch.cuda.synchronize()
        ok, same, t_err = drain_same(torch, got, want)
        if not ok or got[3].any():
            raise AssertionError(f"phase 17: K6 {row['label']}: rows/count/fetches equal {same}, "
                                 f"least t rel {t_err}, fetches {int(got[3].sum())}")
        lanes_visits = row["blocks"] * visit_lab.BLOCK * row["visits"]
        macs = (4 * 16 * kt if qp == 1 else 64 * 4 * kt) * lanes_visits
        peak = PEAK_BF16_FLOPS if row["precision"] == "DEFAULT" or bf16 else PEAK_F32_FLOPS
        nbytes = (geo.numel() + 16 * qp * visit_lab.BLOCK) * geo.element_size() + got[0].numel() * 4
        row["bound_ms"], row["bound_by"] = lab_bound(
            [(2.0 * macs, peak), (CHAIN_FLOPS * kt * lanes_visits, PEAK_F32_FLOPS)], nbytes)
        row.update(max_abs_err=(got[0] - want[0]).abs().max().item(), tmin_rel_err=t_err,
                   accepted=int(got[1].sum().item()), plain_ms=start.elapsed_time(end),
                   design=drain_design(row["precision"], bf16),
                   tflops=2.0 * macs / row["ms"] / 1e9, bound_share=row["bound_ms"] / row["ms"])
        log(f"phase 17: K6 {row['label']} ({row['design']}): {row['ms']:.3f} ms per launch, "
            f"{row['us_per_visit']:.4f} us per visit of a block, {row['tflops']:.2f} TFLOP/s of "
            f"products, bound {row['bound_ms']:.3f} ms ({row['bound_by']}; "
            f"{row['bound_share']:.3f} of it), plain {row['plain_ms']:.1f} ms; rows and counts "
            f"equal ({row['accepted']} accepted), least t within {t_err:.3g}, fetches 0 [{smi}]")
        del got, want

    def kernel_row(name, source, first, checks, **extra):
        k = kernels[name]
        return {
            "name": k.name, "route": "cuda", "source": source, "replaces": k.replaces,
            "launches": launches[name], "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first.get("library_ms"), **extra,
        }

    src = "kazen_tpu_torch/lab/csrc/lab.cu"
    head = next(r for r in mm_rows if (r["kind"], r["M"], r["K"]) == ("HIGHEST", 1024, 128))
    k6_regs = {name: r for name, r in regs.items() if name.startswith("drain")}
    rows = [
        kernel_row("K4", src, head, mm_rows + padded, shape="HIGHEST M=1024 K=128 N=1024 reps 512",
                   design={kind: "simt f32" for kind in ("HIGHEST", "DEFAULT", "bf16-in")},
                   library="512 x (torch.mm + add_)", library_out_dtype=out_dtype,
                   library_device_ms=head["library_device_ms"],
                   ms_by_shape={f"{r['kind']} M={r['M']} K={r['K']}": r["ms"]
                                for r in mm_rows + padded}),
        kernel_row("K5", src, chain_row, [chain_row], shape="(512, 1024), 32 reps",
                   call_ms=chain_row["call_ms"], floor_ms=chain_row["floor_ms"],
                   meets=chain_row["meets"]),
        kernel_row("K6", src, drain_rows[0], drain_rows,
                   shape=f"{drain_rows[0]['label']}, blocks 506, visits 40",
                   design={"HIGHEST": drain_design("HIGHEST", False),
                           "DEFAULT": drain_design("DEFAULT", False),
                           "bf16": drain_design("DEFAULT", True)},
                   registers=k6_regs,
                   ms_by_config={r["label"]: r["ms"] for r in drain_rows}),
    ]
    return rows, {"launches": launches, "mm": mm_rows, "mm_padded": padded, "chain": chain_row,
                  "drain": drain_rows, "registers": regs}


# ---------------------------------------------------------------------------
# phase 18: the stage attribution of a pass and the glue micro-costs
# ---------------------------------------------------------------------------

NAMED_SHARE = 0.95  # of a profiled pass's device time the named stages must hold


def phase_measure(torch, D, smi, out_dir):
    """Phase 18: kazen_tpu_torch/lab/profile_pass2.py and glue_lab.py on the
    card. profile_pass2's rows on the stand-in at 1080p; the stage
    attribution of a stand-in, a pmj02bn and a Textured pass (named stages
    >= NAMED_SHARE of each pass's device time, every device activity traced
    to its launch, every stage launching), pmj02bn's syncs and its pass
    with the sampler's tables built by render() and given to it, Textured's
    texture-fetch sites; every glue_lab row at 2,073,600 lanes, each alternative equal to its plain row
    (glue_lab raises otherwise). Writes chip_smoke_phase18.json to out_dir."""
    from kazen_tpu_torch.integrate.render import render, sampler_spec
    from kazen_tpu_torch.lab import glue_lab, profile_pass2 as pp2
    from kazen_tpu_torch.scene.compiler import compile_scene

    dev = torch.device("cuda")
    scenes = {
        "stand-in": lambda: stand_in_scene(D, WIDTH, HEIGHT),
        "pmj02bn": lambda: stand_in_scene(D, WIDTH, HEIGHT, sampler="pmj02bn"),
        "Textured": lambda: textured_scene(D, WIDTH, HEIGHT),
    }
    out = {"card": smi, "attribution": {}}
    for label, make in scenes.items():
        scene, static = compile_scene(make(), device="cuda")
        spec = sampler_spec(static)
        if label == "stand-in":
            log(f"phase 18: profile_pass2's rows, stand-in {WIDTH}x{HEIGHT} [{smi}]")
            out["rows"] = pp2.stage_rows(scene, static, spec)
        att = pp2.attribute(lambda: render(scene, static, spec, device="cuda"), dev)
        out["attribution"][label] = att
        pp2.print_attribution(f"phase 18: {label} [{smi}]", att)
        if att["named_share"] < NAMED_SHARE or att["unmatched_launches"]:
            raise AssertionError(f"phase 18: {label}: named stages {att['named_share']:.4f} of "
                                 f"the device time, {att['unmatched_launches']} unmatched")
        idle = [s for s, c in att["stages"].items() if c["launches"] == 0]
        if idle:  # a renamed function would move its stage's launches elsewhere
            raise AssertionError(f"phase 18: {label}: no launch attributed to {idle}")
        if label == "pmj02bn":
            # render() builds the sampler's tables on each call unless it is
            # given them: the pass with and without, in turns
            t0 = time.perf_counter()
            sampler_spec(static)
            torch.cuda.synchronize()
            att["spec_ms"] = (time.perf_counter() - t0) * 1e3
            passes = {"built": [], "given": []}
            for k in ("built", "given", "given", "built"):
                given = spec if k == "given" else None
                passes[k].append(cuda_ms(torch, lambda: render(scene, static, given,
                                                               device="cuda"), 3))
            att["pass_ms"] = {k: float(np.mean(v)) for k, v in passes.items()}
            log(f"  pmj02bn: the sampler's tables take {att['spec_ms']:.1f} ms of host time to "
                f"build; pass {att['pass_ms']['built']:.2f} ms when render() builds them, "
                f"{att['pass_ms']['given']:.2f} ms when it is given them (each the mean of 2 x 3 "
                f"passes, in turns; CUDA events) [{smi}]")
        if label == "Textured" and not att["texture_sites"]:
            raise AssertionError("phase 18: Textured: no texture-fetch site was found")
        del scene
    log(f"phase 18: glue_lab at {glue_lab.LANES} lanes [{smi}]")
    out["glue"] = glue_lab.main("cuda")
    with open(os.path.join(out_dir, "chip_smoke_phase18.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# ---------------------------------------------------------------------------
# phase 19: BASELINE.json's configurations
# ---------------------------------------------------------------------------

# the spp each configuration renders at in phase 19 (None: its published
# spp); the published spp of the cut ones run through the module on its own
# (python -m kazen_tpu_torch.examples.baseline_configs N; PERF.md §4)
BASELINE_SPP = {1: None, 2: 9, 3: 8, 4: None}
# what examples/baseline_configs.py 5 prints for kazen_tpu on the CPU
# (`JAX_PLATFORMS=cpu python examples/baseline_configs.py 5`: "recovered
# roughness 0.514 (true 0.35)"); the card's optimize must land within
# CONFIG5_TOLERANCE of it. The value after 80 Adam steps moves with the
# order of the backward's sums (PERF.md §5): eight card runs (atomics) gave
# 0.4957-0.5463, torch's deterministic mode 0.4969, the port on the CPU
# 0.4931. Adam moves every material field by ~lr a step whatever the size
# of its gradient, so a field whose gradient is summation noise takes
# either sign; the card's first step is held to the CPU's by its loss
# (rtol 1e-3) and gradients (rtol 1e-3, atol 1e-3 x the largest |gradient|
# of the table: a float sum's error scales with its terms, not its total)
CONFIG5_ROUGHNESS = 0.514
CONFIG5_TOLERANCE = 0.05
CONFIG5_CHECK_SIZE = 16  # the frame of the first step held to the CPU's


def phase_baseline(torch, smi, kernels, out_dir):
    """Phase 19: examples/baseline_configs.py's configurations 1-5 through
    kazen_tpu_torch/examples/baseline_configs.py on the card. Configs 1-4 at
    64 pixels wide (config 4 64x36), 1 spp, card against the CPU port;
    config 1 at 64x64, 16 spp, through render(), the card's image against
    the CPU's; configs 1-4 at their published sizes (and BASELINE_SPP) by
    run_config, with the launch counts set to 0 before each and read after
    (K1 and K2 on every pass, K3 never), the image finite with mean > 0;
    one pass of each under torch.profiler (config 4 also with its sampler's
    tables built by render() and given to it, in turns); config 5
    (run_inverse): losses finite and falling, the recovered roughness within
    CONFIG5_TOLERANCE of CONFIG5_ROUGHNESS, its first step's loss and
    gradients against the CPU's, and one step under the profiler. Writes
    baseline_configs.json and the images to out_dir."""
    from kazen_tpu_torch.diff import inverse
    from kazen_tpu_torch.examples import baseline_configs as bc
    from kazen_tpu_torch.film.io import save_png
    from kazen_tpu_torch.integrate.render import render, sampler_spec
    from kazen_tpu_torch.scene.compiler import compile_scene

    out = {"card": smi, "small": {}, "configs": {}}
    t0 = time.time()
    for n in (1, 2, 3, 4):
        w, h = (64, 36) if n == 4 else (64, 64)
        err, share = check_li(
            torch, li_lanes(torch, *compile_scene(bc.at_size(bc.config_scene(n), w, h), "cuda")),
            li_lanes(torch, *compile_scene(bc.at_size(bc.config_scene(n), w, h), "cpu")),
            f"config {n} {w}x{h} pass, card vs CPU", 19)
        out["small"][n] = {"max_abs_err": err, "share": share}
    desc = bc.config_scene(1)
    card_img = render(*compile_scene(desc, "cuda"), device="cuda")
    cpu_img = render(*compile_scene(desc, "cpu"), device="cpu")
    err, share = check_li(torch, (card_img, None), (cpu_img, None),
                          "config 1 64x64 16 spp render(), card vs CPU", 19)
    out["config1_16spp"] = {"max_abs_err": err, "share": share}
    log(f"phase 19: the card-vs-CPU checks took {time.time() - t0:.1f} s")

    for n in (1, 2, 3, 4):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        res = bc.run_config(n, BASELINE_SPP[n], "cuda", verbose=False)
        counts = {name: k.launches for name, k in kernels.items()}
        img = res.pop("image")
        passes = res["spp"]
        if counts["K3"] or counts["K1"] < passes or counts["K2"] < passes:
            raise AssertionError(f"phase 19: config {n}: launches {counts} over {passes} passes")
        if not bool(torch.isfinite(img).all()) or not img.mean().item() > 0.0:
            raise AssertionError(f"phase 19: config {n}: image not finite with mean > 0")
        res["launches"] = counts
        res["image_mean"] = img.mean().item()
        save_png(os.path.join(out_dir, f"baseline_config{n}.png"), img.cpu())
        scene, static = compile_scene(bc.config_scene(n), "cuda")
        spec = sampler_spec(static)
        prof = profile_pass(torch, lambda: render(scene, static, spec, spp=1, device="cuda"),
                            out_dir, f"baseline_config{n}")
        res["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "busy_share",
                                                "trace_kernel_ms", "kernel_launches")}
        log(f"phase 19: config {n} {res['width']}x{res['height']} @ {passes} spp "
            f"({res['sampler']}, {res['faces']} faces, {res['clusters']} clusters, compiled in "
            f"{res['compile_s']:.2f} s, sampler tables {res['spec_ms']:.1f} ms): "
            f"{res['render_s']:.3f} s, {res['ms_per_pass']:.2f} ms a pass (passes "
            f"{res['pass_ms_min']:.2f} / {res['pass_ms_median']:.2f} / {res['pass_ms_max']:.2f} "
            f"ms min / median / max), {res['rays_per_s']:.4g} rays/s, "
            f"{res['pixel_samples_per_s']:.4g} pixel-samples/s; K1/K2 "
            f"{counts['K1'] / passes:g}/{counts['K2'] / passes:g} a pass, K3 {counts['K3']} "
            f"[{smi}]")
        log(f"phase 19: config {n} one pass under torch.profiler: {prof['wall_ms']:.2f} ms, "
            f"device {prof['device_ms']:.2f} ms in {prof['kernel_launches']} launches, busy "
            f"{prof['busy_share']:.3f}, trace kernels {prof['trace_kernel_ms']:.2f} ms [{smi}]")
        if static.sampler_kind == "pmj02bn":
            turns = {"built": [], "given": []}
            for k in ("built", "given", "given", "built"):
                given = spec if k == "given" else None
                turns[k].append(cuda_ms(torch, lambda: render(scene, static, given, spp=1,
                                                              device="cuda"), 1))
            res["pass_ms_tables"] = {k: float(np.mean(v)) for k, v in turns.items()}
            log(f"phase 19: config {n} pass {res['pass_ms_tables']['built']:.2f} ms with the "
                f"sampler's tables built by render(), {res['pass_ms_tables']['given']:.2f} ms "
                f"given them (each the mean of 2 passes, in turns) [{smi}]")
        out["configs"][n] = res
        del scene, img
    torch.cuda.empty_cache()

    for k in kernels.values():
        k.launches = 0
    res = bc.run_inverse("cuda")
    counts = {name: k.launches for name, k in kernels.items()}
    losses = np.asarray(res["losses"])
    got = res["recovered_roughness"]
    log(f"phase 19: config 5 {res['width']}x{res['height']}, {res['steps']} steps of "
        f"{res['spp_per_step']} spp: {res['ms_per_step']:.2f} ms a step (min "
        f"{min(res['step_ms']):.2f}, max {max(res['step_ms']):.2f}), target {res['target_ms']:.1f} "
        f"ms; loss {losses[0]:.6g} -> {losses[-1]:.6g}; recovered roughness {got:.4f} (true "
        f"{res['true_roughness']}, kazen_tpu on the CPU {CONFIG5_ROUGHNESS}); launches {counts} "
        f"[{smi}]")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 19: config 5: losses {losses[0]} -> {losses[-1]}")
    if abs(got - CONFIG5_ROUGHNESS) > CONFIG5_TOLERANCE or counts["K3"] or not counts["K1"]:
        raise AssertionError(f"phase 19: config 5 recovered roughness {got} (kazen_tpu "
                             f"{CONFIG5_ROUGHNESS}), launches {counts}")
    first = {}
    for dev in ("cpu", "cuda"):  # at 16x16: the CPU's side at 64x64 takes a minute
        a, st = bc.inverse_scene(CONFIG5_CHECK_SIZE, device=dev)
        if dev == "cpu":
            cpu_target = render(bc.with_roughness(a, bc.TRUE_ROUGHNESS), st, spp=8, device="cpu")
        params = inverse.as_leaves(inverse.get_params(a, ("materials",)))
        img = inverse.render_image(a, st, sampler_spec(st, a.device), params, [0, 1])
        loss = inverse.image_loss(img, cpu_target.to(a.device))
        loss.backward()
        first[dev] = (loss.item(), {f: v.grad.detach().cpu() for f, v in params["materials"].items()
                                    if v.grad is not None})
    (loss_g, g_g), (loss_c, g_c) = first["cuda"], first["cpu"]
    scale = max(g.abs().max().item() for g in g_c.values())
    diff = {f: (g_g[f] - g).abs().max().item() / scale for f, g in g_c.items()}
    loss_rel = abs(loss_g - loss_c) / loss_c
    log(f"phase 19: config 5's first step at {CONFIG5_CHECK_SIZE}x{CONFIG5_CHECK_SIZE}, card vs "
        f"CPU on the CPU's target: loss within "
        f"{loss_rel:.3g} (relative); each field's gradient within {max(diff.values()):.3g} x the "
        f"largest |gradient| ({scale:.3g}): {({f: round(v, 6) for f, v in diff.items()})}")
    if not (loss_rel <= 1e-3 and set(g_g) == set(g_c) and all(
            torch.allclose(g_g[f], g, rtol=1e-3, atol=1e-3 * scale) for f, g in g_c.items())):
        raise AssertionError(f"phase 19: config 5's first step, card vs CPU: loss {loss_rel}, "
                             f"gradients {diff}")
    res["first_step_vs_cpu"] = {"loss_rel": loss_rel, "grad_err_by_field": diff, "scale": scale}
    arrays, static = bc.inverse_scene(device="cuda")
    spec = sampler_spec(static)
    target = render(bc.with_roughness(arrays, bc.TRUE_ROUGHNESS), static, spp=8, device="cuda")

    def one_step():
        params = inverse.as_leaves(inverse.get_params(arrays, ("materials",)))
        img = inverse.render_image(arrays, static, spec, params, [0, 1])
        loss = inverse.image_loss(img, target)
        loss.backward()

    prof = profile_pass(torch, one_step, out_dir, "baseline_config5_step")
    res["launches"] = counts
    res["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "busy_share",
                                            "trace_kernel_ms", "kernel_launches")}
    log(f"phase 19: config 5 one step under torch.profiler: {prof['wall_ms']:.2f} ms, device "
        f"{prof['device_ms']:.2f} ms in {prof['kernel_launches']} launches, busy "
        f"{prof['busy_share']:.3f} [{smi}]")
    out["configs"][5] = res
    with open(os.path.join(out_dir, "baseline_configs.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# ---------------------------------------------------------------------------
# phase 20: the megakernel route's cliff
# ---------------------------------------------------------------------------


def phase_cliff(torch, smi, kernels, out_dir):
    """Phase 20: kazen_tpu_torch/lab/megakernel_cliff.py at 960x540 and
    1920x1080, with the launch counts set to 0 before each and read after:
    the constant box launches K3 once a pass and no K1/K2, the textured one
    K1 and K2 and no K3, and so do the sweep's two routes; each K3 pass is
    held by check_li to the same scene's wavefront pass. Writes
    megakernel_cliff.json to out_dir."""
    from kazen_tpu_torch.lab import megakernel_cliff as mc

    out = {}
    for w, h in ((ORIGINAL_W, ORIGINAL_H), (WIDTH, HEIGHT)):
        for k in kernels.values():
            k.launches = 0
        res = mc.main("cuda", (w, h),
                      check=lambda label, got, want: check_li(torch, got, want, label, 20))
        counts = {name: k.launches for name, k in kernels.items()}
        k3_only, wavefront = [res["const"]], [res["image_texture"]]
        for row in res["sweep"]:
            k3_only.append(row["megakernel"])
            wavefront.append(row["wavefront"])
        bad = [r for r in k3_only if r["launches"] != {"K1": 0, "K2": 0, "K3": 1}]
        bad += [r for r in wavefront
                if r["launches"]["K3"] or not (r["launches"]["K1"] and r["launches"]["K2"])]
        if bad or min(counts.values()) < 1:
            raise AssertionError(f"phase 20: {w}x{h}: routes' launches {bad}, in all {counts}")
        log(f"phase 20: {w}x{h}: const (K3) {res['const']['pass_seconds'] * 1e3:.3f} ms a pass "
            f"({res['const']['pass_ms']}), image_texture (wavefront) "
            f"{res['image_texture']['pass_seconds'] * 1e3:.3f} ms "
            f"({res['image_texture']['pass_ms']}): cliff_x {res['cliff_x']:.4g}; crossover "
            + (f"at {res['crossover_faces']} faces" if res["crossover_faces"] else "none up to 128")
            + f"; launches {counts} [{smi}]")
        for row in res["sweep"]:
            log(f"phase 20: {w}x{h} {row['faces']:4d} faces: K3 "
                f"{row['megakernel']['pass_seconds'] * 1e3:.3f} ms, wavefront "
                f"{row['wavefront']['pass_seconds'] * 1e3:.3f} ms a pass (x{row['ratio']:.4g}) "
                f"[{smi}]")
        out[f"{w}x{h}"] = res
    with open(os.path.join(out_dir, "megakernel_cliff.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# ---------------------------------------------------------------------------
# phase 21: K1's split between node steps and leaves
# ---------------------------------------------------------------------------


def phase_ablate(torch, smi, out_dir):
    """Phase 21: kazen_tpu_torch/lab/kernel_ablate.py on the stand-in (its
    rows at 960x540, its fit over the 1080p pass's K1 launches, bounce 1
    sorted and unsorted at both sizes, random rays and a camera frame), with
    K1's, its nofetch instance's and K2's launch counts set to 0 before and
    read after: the nofetch rows equal the default instance's rows on every
    lane of every set; then the default instance's rows 0-36 (and K2's 0-3)
    against the plain walk on 65,536 lanes of the sorted bounce-1 rays.
    Writes kernel_ablate.json to out_dir."""
    from kazen_tpu_torch.accel import cluster_trace as ct
    from kazen_tpu_torch.integrate.render import sampler_spec
    from kazen_tpu_torch.lab import kernel_ablate as ka
    from kazen_tpu_torch.scene.compiler import compile_scene

    lab_kernels = {"K1": ct.NEAREST, "K1 nofetch": ct.NEAREST_NOFETCH, "K2": ct.ANY_HIT}
    for k in lab_kernels.values():
        k.launches = 0
    res = ka.main("cuda", (ORIGINAL_W, ORIGINAL_H), os.path.join(out_dir, "kernel_ablate.json"),
                  pass_size=(WIDTH, HEIGHT))
    counts = {name: k.launches for name, k in lab_kernels.items()}
    differ = {k: r["nofetch_lanes_differing"] for k, r in res["rows"].items()}
    log(f"phase 21: nofetch rows against the default's over {len(differ)} ray sets: "
        f"{sum(differ.values())} lanes differ; launches {counts} [{smi}]")
    if any(differ.values()) or min(counts.values()) < 1:
        raise AssertionError(f"phase 21: nofetch lanes differing {differ}, launches {counts}")
    scene, static = compile_scene(ka.stand_in_scene(ORIGINAL_W, ORIGINAL_H), "cuda",
                                  megakernel=False)
    rays = ka.bounce1_rays(scene, static, sampler_spec(static))
    res["walk_share"] = check_walk(torch, ct, scene.trace_tables, rays,
                                   f"bounce 1 sorted {ORIGINAL_W}x{ORIGINAL_H}", phase=21)
    res["counts"] = counts
    return res


# the shade kernel's cases (phase 22): lab/shade_check.py's configurations
# and sizes
SHADE_CASES = (("4", None), ("2", None), ("mixed", (256, 256)), ("mixed_single", (128, 128)))


def phase_shade(torch, smi) -> dict:
    """Phase 22: the shade kernel held against its plain version on every
    bounce of one pass of each SHADE_CASES case, then the main path's route
    in a con-2 render() pass (the kernel) and in passes of scenes and calls
    outside the kernel's class (the plain version); the kernel's row of the
    kernel table."""
    from kazen_tpu_torch.diff.inverse import optimize
    from kazen_tpu_torch.examples import baseline_configs as bc
    from kazen_tpu_torch.integrate.render import render
    from kazen_tpu_torch.scene import description as D
    from kazen_tpu_torch.lab import shade_check
    from kazen_tpu_torch.scene.compiler import compile_scene
    from kazen_tpu_torch.shade import bounce_kernel
    from kazen_tpu_torch.utils import metrics

    cases = {}
    for config, size in SHADE_CASES:
        out = shade_check.main(config, size)
        cases[config] = {k: v for k, v in out.items() if k != "records"}
        cases[config]["bounce_ms"] = [r["ms"] for r in out["records"]]
        cases[config]["bounce_plain_ms"] = [r["plain_ms"] for r in out["records"]]
        depth = len(out["records"])
        log(f"phase 22: {config} {out['width']}x{out['height']}: kernel {out['ms_per_launch']:.4f}"
            f" ms a launch (bound {out['bound_ms']:.4f}), plain {out['plain_ms']:.3f} ms; "
            f"shade_route {out['shade_route']}, launches {out['kernel_launches']}; {smi}")
        if not out["equal"]:
            raise AssertionError(f"phase 22: {config}: columns differ: {out['differ']}")
        if out["shade_route"] != {"kernel": depth} or out["kernel_launches"] != depth:
            raise AssertionError(f"phase 22: {config}: the main path did not launch the kernel "
                                 f"on every bounce: {out['shade_route']}, "
                                 f"{out['kernel_launches']} launches")
    scene, static = compile_scene(bc.config_scene(4, spp=1), device="cuda")
    metrics.collect()
    before = bounce_kernel.SHADE.launches
    with metrics.tracing():
        render(scene, static, spp=1, device="cuda")
    got = metrics.collect()
    launches = bounce_kernel.SHADE.launches - before
    log(f"phase 22: con-2 render() pass: shade_route {got['shade_route']}, "
        f"{launches} shade kernel launches")
    if got["shade_route"] != {"kernel": static.max_depth} or launches != static.max_depth:
        raise AssertionError("phase 22: render() did not take the shade kernel on every bounce")
    plain_routes = {}
    for name, desc in (("config 3", bc.at_size(bc.config_scene(3, spp=1), SMALL_W, SMALL_W)),
                       ("Textured", textured_scene(D, SMALL_W, SMALL_H)),
                       ("con-2 optimize", bc.at_size(bc.config_scene(4, spp=1), SMALL_W,
                                                     SMALL_H))):
        sc, st = compile_scene(desc, device="cuda")
        metrics.collect()
        with metrics.tracing():
            if name.endswith("optimize"):
                optimize(sc, st, torch.full((st.height, st.width, 3), 0.25, device="cuda"),
                         steps=1)
            else:
                render(sc, st, spp=1, device="cuda")
        plain_routes[name] = metrics.collect()["shade_route"]
        log(f"phase 22: {name} {st.width}x{st.height}: shade_route {plain_routes[name]}")
        if plain_routes[name] != {"plain": st.max_depth}:
            raise AssertionError(f"phase 22: {name} did not take the plain shade stage")
    con2 = cases["4"]
    return {"cases": cases, "render_shade_route": got["shade_route"],
            "plain_routes": plain_routes, "row": {
        "name": bounce_kernel.SHADE.name, "route": "cuda",
        "source": "kazen_tpu_torch/shade/csrc/bounce.cu", "replaces": bounce_kernel.SHADE.replaces,
        "launches": launches, "ms": con2["ms_per_launch"], "bound_ms": con2["bound_ms"],
        "bound_by": "bytes", "plain_ms": con2["plain_ms"], "library_ms": None,
        "agreement": "bit for bit on every column"}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from kazen_tpu_torch import lab
    from kazen_tpu_torch.accel import cluster_trace as ct
    from kazen_tpu_torch.accel.native import library_path as bvh_library
    from kazen_tpu_torch.core.device import card_line
    from kazen_tpu_torch.integrate import megakernel as mk
    from kazen_tpu_torch.integrate.render import render, sampler_spec
    from kazen_tpu_torch.lab import kernel_ablate
    from kazen_tpu_torch.scene import description as D
    from kazen_tpu_torch.scene.compiler import compile_scene
    from kazen_tpu_torch.shade import bounce_kernel

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    kernels = {"K1": ct.NEAREST, "K2": ct.ANY_HIT, "K3": mk.MEGAKERNEL}

    # ---- phase 0: build -------------------------------------------------
    t_start = t0 = time.time()
    with ThreadPoolExecutor(4) as pool:
        f_trace = pool.submit(ct.build_library)
        f_mega = pool.submit(mk.build_library)
        f_lab = pool.submit(lab.build_library)
        f_shade = pool.submit(bounce_kernel.build_library)
        f_bvh = pool.submit(bvh_library)
        nvcc_out = {"trace": f_trace.result()[1], "megakernel": f_mega.result()[1],
                    "lab": f_lab.result()[1], "shade": f_shade.result()[1]}
        f_bvh.result()
    build_s = time.time() - t0
    smi = card_line()  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    log(f"phase 0: built the trace kernels, the megakernel, the lab probes, the shade kernel "
        f"and the BVH builder in {build_s:.1f} s")
    for line in nvcc_out["shade"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas (shade): {line.strip()}")
    for line in nvcc_out["lab"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas (lab): {line.strip()}")
    for line in nvcc_out["trace"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas (trace): {line.strip()}")
    trace_regs = trace_registers(nvcc_out["trace"])
    log(f"phase 0: K1/K2 (serial and cooperative drain in one kernel each, min_idle a "
        f"launch argument, {ct.COOP_MIN_IDLE} on the main path), registers and bytes of spill "
        f"stores: {trace_regs}")
    k3_ptxas = k3_registers(nvcc_out["megakernel"])
    for b, (regs, spill) in sorted(k3_ptxas.items()):
        log(f"phase 0: K3 instance B={b}: {regs} registers, {spill} bytes of spill stores "
            f"(the most over the three samplers)")
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    log(smi)  # the card's name and power limit, as nvidia-smi gives them

    # ---- phase 1: kernels vs plain on the card ---------------------------
    t0 = time.time()
    scene, static = compile_scene(stand_in_scene(D, WIDTH, HEIGHT), device="cuda")
    tables = scene.trace_tables
    n_faces = int(scene.F.shape[0])
    log(f"phase 1: stand-in scene {n_faces} faces, {tables.num_clusters} clusters, "
        f"{tables.node_scalars.shape[0]}x{tables.node_scalars.shape[1]} node table, "
        f"BVH by the {tables.builder} builder, compiled in {time.time() - t0:.1f} s")
    if n_faces != 36_876:
        raise AssertionError(f"stand-in scene has {n_faces} faces, expected 36876")
    spec = sampler_spec(static)
    rand = kernel_ablate.random_rays(N_RANDOM, dev)  # seeded with SEED (7)
    rand_short = rand.clone()
    rand_short[7] = 1.5
    _, cam = camera_rays(torch, scene, static, spec)
    frame = ct.pack_rays(cam.o, cam.d, cam.mint, cam.maxt)
    frame_short = ct.pack_rays(cam.o, cam.d, cam.mint, torch.full_like(cam.maxt, 3.0))
    e1a, s1a, _ = check_nearest(torch, ct, tables, rand, "random rays")
    e1b, s1b, _ = check_nearest(torch, ct, tables, frame, "camera frame")
    e2a, s2a, _ = check_any_hit(torch, ct, tables, rand_short, "random rays, maxt 1.5")
    e2b, s2b, _ = check_any_hit(torch, ct, tables, frame_short, "camera frame, maxt 3")
    check = {
        "K1": (max(e1a, e1b), min(s1a, s1b)),
        "K2": (max(e2a, e2b), min(s2a, s2b)),
    }
    walk_share = min(
        check_walk(torch, ct, tables, rand, "random rays"),
        check_walk(torch, ct, tables, frame, "camera frame (middle slice)",
                   start=(frame.shape[1] - N_WALK) // 2),
    )
    del rand, rand_short, frame, frame_short
    torch.cuda.synchronize()

    # ---- phase 2: path on the card vs the port on the CPU ---------------
    small = stand_in_scene(D, SMALL_W, SMALL_H)
    check_li(torch, li_lanes(torch, *compile_scene(small, device="cuda")),
             li_lanes(torch, *compile_scene(small, device="cpu")),
             f"{SMALL_W}x{SMALL_H} pass, card vs CPU", 2)

    # ---- phase 3: the main path at full size -----------------------------
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    img = render(scene, static, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"phase 3: warm-up pass {warm_s * 1e3:.1f} ms (host clock), launches "
        f"K1 {launches['K1']}, K2 {launches['K2']}, K3 {launches['K3']}")
    for name in ("K1", "K2"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 3: {name} was not launched on the main path")
    if launches["K3"] != 0:
        raise AssertionError("phase 3: the stand-in scene took the megakernel")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("phase 3: image is not a finite (1080, 1920, 3) array")
    img_mean = img.mean().item()
    if not img_mean > 0.0:
        raise AssertionError("phase 3: image mean is not > 0")
    pass_ms = cuda_ms(torch, lambda: render(scene, static, device="cuda"), 3)
    from kazen_tpu_torch.integrate.render import _render_pass, pixel_grid
    from kazen_tpu_torch.core import rng
    from kazen_tpu_torch.film import film as film_mod

    px, py = pixel_grid(static, dev)
    _, nrays = _render_pass(
        scene, static, spec, film_mod.make_film(static, dev), px, py, 0,
        rng.advance_constants(0),
    )
    nrays_stand_in = float(nrays.item())
    log(f"phase 3: 1920x1080 1-spp depth-5 pass {pass_ms:.2f} ms (mean of 3, CUDA "
        f"events), {nrays_stand_in / pass_ms * 1e3:.4g} rays/s, "
        f"{WIDTH * HEIGHT / pass_ms * 1e3:.4g} pixel-samples/s, image mean "
        f"{img_mean:.5f} [{smi}]")
    from kazen_tpu_torch.film.io import save_png

    save_png(os.path.join(out_dir, "chip_smoke_1080p.png"), img.cpu())

    # ---- phase 4: kernel times at the main-path shapes -------------------
    captured = {"K1": [], "K2": []}
    trace_cuda, occluded_cuda = ct.trace_cuda, ct.occluded_cuda

    def rec_trace(tables_, rays_):
        captured["K1"].append(rays_.clone())
        return trace_cuda(tables_, rays_)

    def rec_occluded(tables_, rays_):
        captured["K2"].append(rays_.clone())
        return occluded_cuda(tables_, rays_)

    ct.trace_cuda, ct.occluded_cuda = rec_trace, rec_occluded
    try:
        render(scene, static, device="cuda")
    finally:
        ct.trace_cuda, ct.occluded_cuda = trace_cuda, occluded_cuda
    torch.cuda.synchronize()
    fns = {"K1": trace_cuda, "K2": occluded_cuda}
    pass_launches = {name: launches[name] for name in fns}
    table_bytes = {
        "K1": sum(t.numel() * 4 for t in (tables.node_scalars, tables.tri, tables.geo_shade)),
        "K2": sum(t.numel() * 4 for t in (tables.node_scalars, tables.tri)),
    }
    # rays in (8 rows) and the output rows a consumer reads: rows 0-33 of
    # the nearest hit (34-36 are diagnostics, 37-39 zeros) and row 0 of the
    # any hit (1-3 are diagnostics, 4-7 zeros)
    io_rows = {"K1": 8 + 34, "K2": 8 + 1}
    diag_rows = {"K1": (35, 36), "K2": (2, 3)}  # node steps, triangle tests
    sweep = sorted(set(MIN_IDLE_SWEEP) | {ct.COOP_MIN_IDLE})
    rows = []
    for name, kfn in fns.items():
        ms_each, bound_each, by_each, tests_total = [], [], [], 0.0
        simt_leaf, simt_step, differ = [], [], []
        sweep_ms = {m: [] for m in sweep}
        step_row, test_row = diag_rows[name]
        for idx, rays_ in enumerate(captured[name]):
            ref = kfn(tables, rays_, SERIAL)
            tests = ref[test_row].double().sum().item()
            tests_total += tests
            nbytes = io_rows[name] * 4 * rays_.shape[1] + table_bytes[name]
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = tests * MT_FLOPS / PEAK_F32_FLOPS * 1e3
            bound_each.append(max(t_bytes, t_ops))
            by_each.append("bytes" if t_bytes >= t_ops else "operations")
            ms_each.append(cuda_ms(torch, lambda: kfn(tables, rays_), 3))
            simt_leaf.append(simt_efficiency(torch, ref[test_row]))
            simt_step.append(simt_efficiency(torch, ref[step_row]))
            # every drain threshold gives the serial drain's rows
            n_differ = 0
            for m in sweep:
                same = (kfn(tables, rays_, m)[:test_row + 1] == ref[:test_row + 1]).all(0)
                n_differ = max(n_differ, int((~same).sum().item()))
            differ.append(n_differ)
            if n_differ > 1e-5 * rays_.shape[1]:
                raise AssertionError(f"phase 4: {name} launch {idx + 1}: {n_differ} lanes differ "
                                     f"from min_idle {SERIAL} (> 0.001%)")
            # ms per launch at each threshold, in turns (forward, then back)
            for order in (sweep, sweep[::-1]):
                for m in order:
                    sweep_ms[m].append(cuda_ms(torch, lambda m=m: kfn(tables, rays_, m), 3))
            log(f"phase 4: {name} launch {idx + 1}: N={rays_.shape[1]} SIMT efficiency leaves "
                f"{simt_leaf[-1]:.4f} steps {simt_step[-1]:.4f}; ms by min_idle "
                + ", ".join(f"{m}: {np.mean(sweep_ms[m][-2:]):.4f}" for m in sweep)
                + f"; lanes differing from min_idle {SERIAL}: {n_differ} [{smi}]")
        # the kernel held against its plain version on the pass's first
        # launch (camera rays / first shadow rays), whose plain call gives
        # the plain version's time (phase 1 warmed it up), and its third
        # (bounce rays: surface origins, dead lanes, sorted order)
        check_fn = check_nearest if name == "K1" else check_any_hit
        for idx in (0, 2):
            err, share, p_ms = check_fn(
                torch, ct, tables, captured[name][idx], f"main-path launch {idx + 1}",
                phase=4,
            )
            check[name] = (max(check[name][0], err), min(check[name][1], share))
            if idx == 0:
                plain_ms = p_ms
        by_min_idle = {str(m): float(np.mean(v)) for m, v in sweep_ms.items()}
        k = kernels[name]
        entry = {
            "name": k.name,
            "route": "cuda",
            "source": "kazen_tpu_torch/accel/csrc/cluster_trace.cu",
            "replaces": k.replaces,
            "launches": pass_launches[name],
            "max_abs_err": check[name][0],
            "ms": float(np.mean(ms_each)),
            "plain_ms": plain_ms,
            "ms_first_launch": ms_each[0],
            "bound_ms": float(np.mean(bound_each)),
            "bound_by": max(set(by_each), key=by_each.count),
            "library_ms": None,
            "agreement": check[name][1],
            "walk_agreement": walk_share,
            "min_idle": ct.COOP_MIN_IDLE,
            "ms_per_launch": [round(x, 4) for x in ms_each],
            "ms_by_min_idle": by_min_idle,
            "ms_per_launch_serial": [
                round(float(np.mean(sweep_ms[SERIAL][2 * i:2 * i + 2])), 4)
                for i in range(len(ms_each))
            ],
            "simt_leaf": [round(x, 4) for x in simt_leaf],
            "simt_step": [round(x, 4) for x in simt_step],
            "lanes_differing": differ,
            "tests_per_pass": tests_total,
        }
        rows.append(entry)
        log(f"phase 4: {name} {k.name}: {entry['ms']:.3f} ms per launch at min_idle "
            f"{ct.COOP_MIN_IDLE} over {len(ms_each)} main-path launches "
            f"({entry['ms_per_launch']}), bound {entry['bound_ms']:.4f} ms by "
            f"{entry['bound_by']}, plain version {plain_ms:.1f} ms on the first launch's rays "
            f"(kernel {ms_each[0]:.3f} ms) [{smi}]")
        log(f"phase 4: {name} mean ms per launch by min_idle "
            + ", ".join(f"{m}: {v:.4f}" for m, v in by_min_idle.items())
            + f"; first launch at {ct.COOP_MIN_IDLE} / at {SERIAL}: "
            f"{np.mean(sweep_ms[ct.COOP_MIN_IDLE][:2]) / np.mean(sweep_ms[SERIAL][:2]):.4f} [{smi}]")
    check_walk(torch, ct, tables, captured["K1"][2], "main-path launch 3", phase=4)

    # the stand-in pass with both kernels at the serial drain against the
    # module constant, in turns (constant, serial, serial, constant)
    def serial_pass():
        ct.trace_cuda = lambda t, r: trace_cuda(t, r, SERIAL)
        ct.occluded_cuda = lambda t, r: occluded_cuda(t, r, SERIAL)
        try:
            return cuda_ms(torch, lambda: render(scene, static, device="cuda"), 3)
        finally:
            ct.trace_cuda, ct.occluded_cuda = trace_cuda, occluded_cuda

    def constant_pass():
        return cuda_ms(torch, lambda: render(scene, static, device="cuda"), 3)

    ab = {"constant": [constant_pass()], "serial": [serial_pass()]}
    ab["serial"].append(serial_pass())
    ab["constant"].append(constant_pass())
    pass_ab = {k_: float(np.mean(v)) for k_, v in ab.items()}
    log(f"phase 4: stand-in pass {pass_ab['constant']:.2f} ms at min_idle {ct.COOP_MIN_IDLE}, "
        f"{pass_ab['serial']:.2f} ms at {SERIAL} (each the mean of 2 x 3 passes, in turns) [{smi}]")
    del captured
    torch.cuda.synchronize()

    # ---- phase 5: where the time of one pass of each path goes ------------
    mixed, mixed_static = compile_scene(mixed_scene(D, WIDTH, HEIGHT), device="cuda")
    toy, toy_static = compile_scene(toy_scene(D, WIDTH, HEIGHT), device="cuda")
    if not (mixed_static.use_megakernel and toy_static.use_megakernel):
        raise AssertionError("phase 5: Mixed and Toy must take the megakernel on CUDA")
    profiles = {}
    for label, sc, st in (("stand_in", scene, static), ("mixed", mixed, mixed_static)):
        prof = profile_pass(torch, lambda: render(sc, st, device="cuda"), out_dir, label)
        profiles[label] = prof
        log(f"phase 5: {label} profiled pass {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['device_ms']:.2f} ms ({prof['busy_share']:.3f}), trace kernels "
            f"{prof['trace_kernel_ms']:.2f} ms, megakernel {prof['megakernel_ms']:.2f} ms, "
            f"{prof['kernel_launches']} launches [{smi}]")
        for row in prof["top"][:8]:
            log(f"  {row['device_ms']:9.3f} ms {row['count']:6d}x  {row['name'][:90]}")

    # ---- phase 6: K3 against its plain version on the card ----------------
    from kazen_tpu_torch.integrate.path_mis import li_wavefront

    def k3_inputs(sc, st, sample):
        """Sample pass ``sample``'s streams and camera rays, contiguous as the
        kernel takes them."""
        spec_ = sampler_spec(st)
        stream_, rays_ = camera_rays(torch, sc, st, spec_, sample)
        stream_ = type(stream_)(*(f.contiguous() for f in stream_))
        return spec_, stream_, rays_._replace(o=rays_.o.contiguous(), d=rays_.d.contiguous())

    def li_of(out):
        return out[0:3].T, out[3].double().sum().item()

    frames = {"Mixed 1080p independent": (mixed, mixed_static, 0)}
    for sampler, spp, sample in (("stratified", 4, 2), ("correlated", 8, 1)):
        frames[f"Mixed {SMALL_W}x{SMALL_H} {sampler}"] = (
            *compile_scene(mixed_scene(D, SMALL_W, SMALL_H, sampler, spp), device="cuda"),
            sample,
        )
    for label, light in (("regularization + background", True), ("no lights", False)):
        frames[f"{label} {SMALL_W}x{SMALL_H}"] = (
            *compile_scene(variant_scene(D, SMALL_W, SMALL_H, light), device="cuda"), 0,
        )
    k3_err, k3_share, k3_out = 0.0, 1.0, {}
    for label, (sc, st, sample) in frames.items():
        spec_, stream_, rays_ = k3_inputs(sc, st, sample)
        out_k = mk.megakernel_cuda(sc.mega, st.mega_cfg, rays_.o, rays_.d, stream_)
        out_p, p_ms = timed(
            torch, lambda: mk.megakernel_plain(sc.mega, st.mega_cfg, rays_.o, rays_.d, stream_)
        )
        k3_out[label] = (out_k, out_p, p_ms)
        # rows 0-5 equal on every lane, for both schedules
        for refill in (0, 1):
            out_r = mk.megakernel_cuda(
                sc.mega, st.mega_cfg, rays_.o, rays_.d, stream_, refill=refill
            )
            differ = int((out_r != out_p).any(0).sum().item())
            by_row = [int((out_r[r] != out_p[r]).sum().item()) for r in range(mk.OUT_ROWS)]
            log(f"phase 6: K3 refill {refill} vs plain, {label}: rows 0-5 differ on {differ} "
                f"of {out_p.shape[1]} lanes (by row {by_row})")
            if differ:
                raise AssertionError(f"phase 6: K3 refill {refill}, {label}: {differ} lanes differ "
                                     f"from the plain version")
        err, share = check_li(torch, li_of(out_k), li_of(out_p), f"K3 vs plain, {label}", 6)
        k3_err, k3_share = max(k3_err, err), min(k3_share, share)
        log(f"phase 6: plain version {p_ms:.1f} ms on {label}")

    # ---- phase 7: K3 against the wavefront on the card --------------------
    for label, (sc, st, sample) in frames.items():
        spec_, stream_, rays_ = k3_inputs(sc, st, sample)
        check_li(torch, li_of(k3_out[label][0]), li_wavefront(sc, st, spec_, stream_, rays_)[1:],
                 f"K3 vs li_wavefront, {label}", 7)

    # ---- phase 8: the megakernel path on the card against the CPU -----------
    small = mixed_scene(D, SMALL_W, SMALL_H)
    gpu_scene, gpu_static = compile_scene(small, device="cuda")
    cpu_scene, cpu_static = compile_scene(small, device="cpu", megakernel=True)
    check_li(torch, li_lanes(torch, gpu_scene, gpu_static),
             li_lanes(torch, cpu_scene, cpu_static),
             f"Mixed {SMALL_W}x{SMALL_H} pass, card vs CPU", 8)

    # ---- phase 9: the megakernel path at full size ------------------------
    passes = {}
    for label, sc, st in (("Mixed", mixed, mixed_static), ("Toy", toy, toy_static)):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        img = render(sc, st, device="cuda")
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        counts = {name: k.launches for name, k in kernels.items()}
        log(f"phase 9: {label} 1080p warm-up pass {warm_s * 1e3:.1f} ms (host clock), "
            f"launches K1 {counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}")
        if counts["K3"] != st.sample_count or counts["K1"] or counts["K2"]:
            raise AssertionError(f"phase 9: {label} did not take the megakernel route: {counts}")
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"phase 9: {label} image is not a finite (1080, 1920, 3) array")
        mean = img.mean().item()
        if not mean > 0.0:
            raise AssertionError(f"phase 9: {label} image mean is not > 0")
        ms_ = cuda_ms(torch, lambda: render(sc, st, device="cuda"), 3)
        spec_, stream_, rays_ = k3_inputs(sc, st, 0)
        captured = []
        kernel_fn = mk.megakernel_cuda

        def rec(tables_, cfg_, o_, d_, stream__):
            captured.append((o_.clone(), d_.clone(), type(stream__)(*(f.clone() for f in stream__))))
            return kernel_fn(tables_, cfg_, o_, d_, stream__)

        mk.megakernel_cuda = rec
        try:
            render(sc, st, device="cuda")
        finally:
            mk.megakernel_cuda = kernel_fn
        o_, d_, stream__ = captured[0]
        if not (torch.equal(o_, rays_.o) and torch.equal(d_, rays_.d)):
            raise AssertionError(f"phase 9: {label}'s launch input is not the sample-0 frame")
        out = kernel_fn(sc.mega, st.mega_cfg, o_, d_, stream__)
        k_ms = cuda_ms(torch, lambda: kernel_fn(sc.mega, st.mega_cfg, o_, d_, stream__), 5)
        nrays = out[3].double().sum().item()
        tests = out[4].double().sum().item()
        bounces = out[5].double().sum().item()
        table_bytes = sum(
            t.numel() * 4 for t in (sc.mega.geo, sc.mega.attr, sc.mega.mats,
                                    sc.mega.light_tris, sc.mega.light_cdf, sc.mega.light_info)
        )
        t_bytes = (K3_IO_BYTES * o_.shape[0] + table_bytes) / PEAK_BYTES_PER_S * 1e3
        t_ops = (tests * MT_FLOPS + bounces * SHADE_FLOPS) / PEAK_F32_FLOPS * 1e3
        variants = k3_variants(torch, mk, sc, st, o_, d_, stream__, out, label, smi)
        passes[label] = dict(
            pass_ms=ms_, warm_ms=warm_s * 1e3, image_mean=mean, rays=nrays,
            launches=counts["K3"], k3_ms=k_ms, tests=tests, bounces=bounces,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
            bound_unfused_ms=max(t_bytes, t_ops * PEAK_F32_FLOPS / PEAK_F32_UNFUSED),
            row5_simt=simt_efficiency(torch, out[5]), variants=variants,
        )
        log(f"phase 9: {label} 1920x1080 1-spp depth-{st.max_depth} pass {ms_:.3f} ms (mean of "
            f"3, CUDA events), {nrays / ms_ * 1e3:.4g} rays/s, "
            f"{WIDTH * HEIGHT / ms_ * 1e3:.4g} pixel-samples/s, image mean {mean:.5f} [{smi}]")
        log(f"phase 9: {label} K3 {k_ms:.3f} ms per launch (mean of 5) at refill {mk.REFILL}, "
            f"B={mk.MIN_BLOCKS}, {tests:.0f} triangle tests, {bounces:.0f} bounces, {nrays:.0f} "
            f"rays; bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, operations "
            f"{t_ops:.4f}; {passes[label]['bound_unfused_ms']:.4f} at the unfused rate) [{smi}]")
        save_png(os.path.join(out_dir, f"chip_smoke_{label.lower()}_1080p.png"), img.cpu())

    # ---- phase 11: the pmj02bn sampler on the stand-in ----------------------
    t_phase = time.time()
    small = stand_in_scene(D, SMALL_W, SMALL_H, sampler="pmj02bn")
    check_li(torch, li_lanes(torch, *compile_scene(small, device="cuda")),
             li_lanes(torch, *compile_scene(small, device="cpu")),
             f"pmj02bn {SMALL_W}x{SMALL_H} pass, card vs CPU", 11)
    pmj = full_pass(torch, *compile_scene(stand_in_scene(D, WIDTH, HEIGHT, sampler="pmj02bn"),
                                          device="cuda"), kernels, "pmj02bn stand-in", 11, smi,
                    need=("K1", "K2"), out_dir=out_dir)
    log(f"phase 11: {time.time() - t_phase:.1f} s")

    # ---- phase 12: the debug integrators on the stand-in ---------------------
    t_phase = time.time()
    integrators = {}
    for kind in ("normals", "ao", "whitted", "path_mats"):
        integ = D.SimpleIntegrator(kind=kind, max_depth=16 if kind == "whitted" else DEPTH)
        small = stand_in_scene(D, SMALL_W, SMALL_H, integrator=integ)
        on_card = compile_scene(small, device="cuda")
        got = li_lanes(torch, *on_card)
        if kind == "whitted":
            # whitted's shadow ray ends exactly on the light point (maxt =
            # dist, the reference's semantics), so the light's own hit at
            # t ~ maxt decides occlusion by the last bit of arithmetic done
            # before it (the card's and the CPU's sin, cos and sums differ)
            # and by whether the light's cluster box survives the slab test
            # (the walk culls it where the brute-force plain trace tests the
            # triangle). K1 is held by the full gate to the plain walk, which
            # it equals bit for bit, on the card; card against CPU by channel
            # means and rays
            trace_cuda = ct.trace_cuda
            ct.trace_cuda = lambda tables_, rays_, *args: ct.trace_walk_plain(tables_, rays_)
            try:
                want = li_lanes(torch, *on_card)
            finally:
                ct.trace_cuda = trace_cuda
            check_li(torch, got, want, f"whitted {SMALL_W}x{SMALL_H} pass, K1 vs the plain walk "
                     f"on the card", 12)
        check_li(torch, got, li_lanes(torch, *compile_scene(small, device="cpu")),
                 f"{kind} {SMALL_W}x{SMALL_H} pass, card vs CPU", 12, lane_gate=kind != "whitted")
        integrators[kind] = full_pass(
            torch, *compile_scene(stand_in_scene(D, WIDTH, HEIGHT, integrator=integ),
                                  device="cuda"),
            kernels, f"{kind} (depth {integ.max_depth}) stand-in", 12, smi, need=("K1",),
        )
    log(f"phase 12: {time.time() - t_phase:.1f} s")

    # ---- phase 13: Textured 1080p ------------------------------------------
    t_phase = time.time()
    small = textured_scene(D, SMALL_W, SMALL_H)
    check_li(torch, li_lanes(torch, *compile_scene(small, device="cuda")),
             li_lanes(torch, *compile_scene(small, device="cpu")),
             f"Textured {SMALL_W}x{SMALL_H} pass, card vs CPU", 13)
    t0 = time.time()
    tex_scene, tex_static = compile_scene(textured_scene(D, WIDTH, HEIGHT), device="cuda")
    compile_s = time.time() - t0
    log(f"phase 13: Textured 1080p compiled in {compile_s:.1f} s: "
        f"{int(tex_scene.F.shape[0])} faces, {int(tex_scene.textures.texels.shape[0])} texels "
        f"in {int(tex_scene.textures.ttype.shape[0])} texture nodes, environment tables "
        f"{tex_static.env_res}")
    textured = full_pass(torch, tex_scene, tex_static, kernels, "Textured", 13, smi,
                         need=("K1", "K2"), out_dir=out_dir)
    textured["compile_s"] = compile_s
    img_grid = render(tex_scene, tex_static, device="cuda")
    img_chunked = render(tex_scene, tex_static, lane_chunk=1 << 18, device="cuda")
    err, share = check_li(torch, (img_chunked, None), (img_grid, None),
                          f"Textured 1080p lane_chunk={1 << 18} (scatter splat) vs grid splat", 13)
    textured["chunked_vs_grid"] = {"max_abs_err": err, "share": share}
    save_png(os.path.join(out_dir, "chip_smoke_textured_1080p.png"), img_grid.cpu())
    log(f"phase 13: {time.time() - t_phase:.1f} s")
    del tex_scene, img_grid, img_chunked
    torch.cuda.empty_cache()

    # ---- phase 14: gradients and inverse rendering on the card ----------
    t_phase = time.time()
    grads = phase_gradients(torch, D, kernels, smi, out_dir)
    log(f"phase 14: {time.time() - t_phase:.1f} s")

    # ---- phase 15: the file front end, checkpoints and the CLI ------------
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as work_dir:
        files = phase_files(torch, D, smi, work_dir)
        log(f"phase 15: {time.time() - t_phase:.1f} s")

        # ---- phase 16: the distributed layer at world size 1 on nccl -------
        t_phase = time.time()
        distributed = phase_distributed(torch, D, smi, scene, static, files.pop("xml"),
                                        grads.pop("stand_in_card_grads"), work_dir)
        log(f"phase 16: {time.time() - t_phase:.1f} s")

    # ---- phase 17: the lab probes K4-K6 ---------------------------------------
    t_phase = time.time()
    lab_rows, lab_out = phase_lab(torch, smi, nvcc_out["lab"])
    log(f"phase 17: {time.time() - t_phase:.1f} s")

    # ---- phase 18: the stage attribution and the glue micro-costs -----------
    t_phase = time.time()
    measure = phase_measure(torch, D, smi, out_dir)
    log(f"phase 18: {time.time() - t_phase:.1f} s")

    # ---- phase 19: BASELINE.json's configurations 1-5 -----------------------
    t_phase = time.time()
    baseline = phase_baseline(torch, smi, kernels, out_dir)
    log(f"phase 19: {time.time() - t_phase:.1f} s")

    # ---- phase 20: the megakernel route's cliff -----------------------------
    t_phase = time.time()
    cliff = phase_cliff(torch, smi, kernels, out_dir)
    log(f"phase 20: {time.time() - t_phase:.1f} s")

    # ---- phase 21: K1's split between node steps and leaves ----------------
    t_phase = time.time()
    ablate = phase_ablate(torch, smi, out_dir)
    log(f"phase 21: {time.time() - t_phase:.1f} s")

    # ---- phase 22: the shade kernel against its plain version ---------------
    t_phase = time.time()
    shade = phase_shade(torch, smi)
    log(f"phase 22: {time.time() - t_phase:.1f} s")
    original = ablate["rows"][ablate["original"]]
    rows[0]["nofetch"] = {
        "ms": original["nofetch_ms"], "default_ms": original["ms"], "rays": ablate["original"],
        "launches": ablate["counts"]["K1 nofetch"],
        "saving_ms_by_set": {k: r["nofetch_saving_ms"] for k, r in ablate["rows"].items()},
    }

    mixed_run = passes["Mixed"]
    chosen = mixed_run["variants"][f"refill {mk.REFILL} B={mk.MIN_BLOCKS}"]
    rows.append({
        "name": mk.MEGAKERNEL.name,
        "route": "cuda",
        "source": "kazen_tpu_torch/integrate/csrc/megakernel.cu",
        "replaces": mk.MEGAKERNEL.replaces,
        "launches": mixed_run["launches"],
        "max_abs_err": k3_err,
        "ms": mixed_run["k3_ms"],
        "plain_ms": k3_out["Mixed 1080p independent"][2],
        "bound_ms": mixed_run["bound_ms"],
        "bound_by": mixed_run["bound_by"],
        "library_ms": None,
        "agreement": k3_share,
        "toy_ms": passes["Toy"]["k3_ms"],
        "tests_per_pass": mixed_run["tests"],
        "bounces_per_pass": mixed_run["bounces"],
        "regs": chosen["regs"],
        "lane_slot_efficiency": chosen["lane_slot_efficiency"],
        "row5_simt_efficiency": mixed_run["row5_simt"],
        "bound_unfused_ms": mixed_run["bound_unfused_ms"],
        "refill": mk.REFILL,
        "min_blocks": mk.MIN_BLOCKS,
        "ms_by_variant": {k_: v["ms"] for k_, v in mixed_run["variants"].items()},
        "toy_ms_by_variant": {k_: v["ms"] for k_, v in passes["Toy"]["variants"].items()},
    })
    rows.extend(lab_rows)
    rows.append(shade.pop("row"))
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "trace_ptxas": trace_regs, "pass_ms": pass_ms,
                   "rays_per_pass": nrays_stand_in,
                   "pass_ms_by_drain": pass_ab, "k3_ptxas": k3_ptxas,
                   "megakernel_passes": passes, "kernels": rows, "profiles": profiles,
                   "pmj02bn": pmj, "integrators": integrators,
                   "textured": textured, "gradients": grads, "files": files,
                   "distributed": distributed, "lab": lab_out,
                   "measure": {k: measure[k] for k in ("rows", "glue")},
                   "baseline": baseline, "cliff": cliff, "ablate": ablate, "shade": shade,
                   "total_s": time.time() - t_start},
                  f, indent=1)
    log(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
