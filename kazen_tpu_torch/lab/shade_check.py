"""The shade kernel held against its plain version on the main path's own
bounces.

``held()`` replaces ``path_mis._shade`` for the duration of a block: each
bounce's shade stage runs by its route (the kernel on the card) and then by
``path_mis._shade_plain`` on the same inputs; the outputs are compared
column by column, bit for bit (floats as their int32 bits, so a NaN equals
only the same NaN), both are timed, and the route's outputs go on down the
pass. ``check_pass`` runs one render pass under it with the tracer on and
returns, per bounce, the lanes that differ in each column, the kernel's and
the plain version's ms and the kernel's bound, with the pass's
``shade_route`` count and kernel launches.

On the CPU the route is the plain version, so the hold compares it with
itself (a rehearsal of the script). ``python -m
kazen_tpu_torch.lab.shade_check --config 4`` runs BASELINE config 4 (con-2)
at its 1920x1080 (``--config 3``: config 3's image-textured and
normal-mapped kiss at 512x512; ``--config mixed``: every lobe of the
kernel's set; ``--config textured``: every texture field and both
normal-mapped lobes, with ``_nomip`` and ``_noaniso`` for the other two
footprints); ``--size 64x36 --device cpu`` rehearses it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from ..core import rng
from ..core.device import resolve_device
from ..film import film as film_mod
from ..integrate import path_mis
from ..integrate.render import _render_pass, pixel_grid, sampler_spec
from ..shade import bounce_kernel
from ..utils import metrics

COLUMNS = ("p", "nee_wi", "smaxt", "pd", "li", "throughput", "eta", "accum", "contrib",
           "bsdf_pdf", "discrete", "alive", "pick", "cluster", "n_shadow_rays", "n_path_rays")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
ROWS_READ = 31  # K1 rows 3-33


def lane_bytes(n_strat: int, draw_rr: bool) -> int:
    """Bytes a lane of the kernel reads and writes once: K1's rows 3-33,
    ray o and d, li and throughput, eta, bsdf_pdf, accum, alive and
    discrete, the uniforms it consumes; out the 24 floats and two int64.
    The texture footprint is derived in the kernel: no column."""
    uniforms = 3 + (4 if n_strat > 0 else 0) + (1 if draw_rr else 0)
    read = 4 * (ROWS_READ + 3 * 4 + 3 + uniforms) + 2
    return read + 4 * bounce_kernel.OUT_COLS + 2 * 8


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def mismatches(got, want) -> dict:
    """{column: lanes (or scalars) whose bits differ} of two ShadeOuts."""
    out = {}
    for name in COLUMNS:
        a, b = _bits(getattr(got, name).contiguous()), _bits(getattr(want, name).contiguous())
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{name}: {a.dtype} {tuple(a.shape)} against "
                             f"{b.dtype} {tuple(b.shape)}")
        ne = a != b
        out[name] = int(ne.reshape(ne.shape[0], -1).any(1).sum()) if ne.dim() else int(ne)
    return out


def _timed(fn, device):
    """(fn(), ms): CUDA events around it on the card, the host clock on the
    CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def held(records: list):
    """``path_mis._shade`` held against ``path_mis._shade_plain`` on every
    bounce of the block; one record a bounce is appended to ``records``."""
    routed = path_mis._shade

    def both(scene, static, st, li, alive, draws):
        dev = st.ray_o.device
        route, reason = bounce_kernel.route_reason(
            scene, static,
            (st.ray_o, st.ray_d, li, st.throughput, st.eta, st.bsdf_pdf, st.accum_rough))
        out, ms = _timed(lambda: routed(scene, static, st, li, alive, draws), dev)
        want, plain_ms = _timed(
            lambda: path_mis._shade_plain(scene, static, st, li, alive, draws), dev)
        n = st.ray_o.shape[0]
        records.append({
            "bounce": len(records) + 1, "route": route, "reason": reason, "lanes": n,
            "ms": ms, "plain_ms": plain_ms,
            "footprint_mode": bounce_kernel.footprint_mode(static),
            "bound_ms": n * lane_bytes(path_mis._nee_strata(static), draws.u_rr is not None)
            / HBM_BYTES_PER_S * 1e3,
            "differ": mismatches(out, want),
        })
        return out

    path_mis._shade = both
    try:
        yield records
    finally:
        path_mis._shade = routed


def check_pass(scene, static, spec=None, sample: int = 0) -> dict:
    """One render pass of the scene with every bounce held: the records,
    the pass's ``shade_route`` count and the kernel's launches in it."""
    dev = scene.device
    spec = spec if spec is not None else sampler_spec(static, dev)
    px, py = pixel_grid(static, dev)
    film = film_mod.make_film(static, dev)
    records = []
    metrics.collect()
    before = bounce_kernel.SHADE.launches
    with metrics.tracing(), held(records):
        _render_pass(scene, static, spec, film, px, py, sample,
                     rng.advance_constants(sample * 65536))
    got = metrics.collect()
    return {"bounces": records, "shade_route": got["shade_route"],
            "launches": bounce_kernel.SHADE.launches - before}


def summary(result: dict) -> dict:
    """Totals of check_pass: lanes differing by column over the bounces, the
    footprint mode the kernel was given, the kernel's ms per launch (mean),
    its bound and the plain version's ms."""
    b = result["bounces"]
    differ = {c: sum(r["differ"][c] for r in b) for c in COLUMNS}
    return {
        "bounces": len(b), "shade_route": result["shade_route"],
        "kernel_launches": result["launches"],
        "footprint_mode": b[0]["footprint_mode"] if b else None,
        "differ": differ, "equal": not any(differ.values()),
        "ms_per_launch": sum(r["ms"] for r in b) / max(len(b), 1),
        "bound_ms": sum(r["bound_ms"] for r in b) / max(len(b), 1),
        "plain_ms": sum(r["plain_ms"] for r in b) / max(len(b), 1),
    }


def mixed_scene(width: int, height: int, sphere: bool = True):
    """Every lobe of the kernel's set in one box: quads of kiss (clearcoat,
    sheen, anisotropy), mirror, GGX, dielectric and lambertian in front of
    the Cornell box's diffuse walls, regularization on; ``sphere`` adds a
    2,208-face anisotropic GGX sphere, so the scene has several clusters
    and the ordered permute runs (without it, one cluster and no
    permute)."""
    from ..examples.baseline_configs import cornell_box, make_mesh, make_sphere
    from ..scene import description as D

    extra = [
        make_mesh([-0.8, 0.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=D.KazenStandard(
            base_color=D.ConstantTexture((0.7, 0.3, 0.2)),
            metallic=D.ConstantTexture((0.4,) * 3), roughness=D.ConstantTexture((0.35,) * 3),
            anisotropy=0.3, specular_tint=0.2, clearcoat=0.6, sheen=0.4)),
        make_mesh([0.2, 0.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=D.Mirror()),
        make_mesh([-0.8, 0.8, 0.6], [0, 0.6, 0], [0.6, 0, 0],
                  bsdf=D.GGX(albedo=D.ConstantTexture((0.9, 0.7, 0.4)), roughness=0.2)),
        make_mesh([0.2, 0.8, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=D.Dielectric()),
        make_mesh([-0.3, 1.3, 0.9], [0, 0.5, 0], [0.6, 0, 0],
                  bsdf=D.Lambertian(albedo=D.ConstantTexture((0.3, 0.6, 0.5)))),
    ]
    if sphere:
        ball = make_sphere([0.45, 0.35, -0.3], 0.3)
        ball.bsdf = D.GGX(albedo=D.ConstantTexture((0.8, 0.8, 0.9)), roughness=0.3,
                          anisotropy=0.5)
        extra.append(ball)
    return cornell_box(width=width, height=height, spp=1, extra_meshes=extra,
                       regularization=True)


def textured_scene(width: int, height: int, mip: bool = True, aniso: bool = True,
                   seed: int = 7):
    """Every material texture field in one box, with texels drawn from
    ``seed``: a kiss quad with image base colour, metallic and roughness
    (clearcoat, sheen, anisotropy), a normal-mapped GGX quad with an image
    albedo, a lambertian quad with an image albedo, a dielectric quad and
    a 2,208-face normal-mapped kiss sphere with image base colour and
    roughness; images of 4 to 64 texels a side, regularization on. ``mip``
    and ``aniso`` set the footprint (trilinear, and the anisotropic
    probes)."""
    import numpy as np

    from ..examples.baseline_configs import cornell_box, make_mesh, make_sphere
    from ..scene import description as D

    rng = np.random.default_rng(seed)

    def image(n, lo=0.0, hi=1.0):
        data = rng.uniform(lo, hi, (n, n, 3)).astype(np.float32)
        return D.ImageTexture(data=data, colorspace="linear")

    bump = np.full((16, 16, 3), (0.5, 0.5, 1.0), np.float32)
    bump[..., :2] += rng.uniform(-0.3, 0.3, (16, 16, 2)).astype(np.float32)
    normals = D.ImageTexture(data=bump, colorspace="linear")
    extra = [
        make_mesh([-0.8, 0.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=D.KazenStandard(
            base_color=image(8), metallic=image(16), roughness=image(32, 0.05, 0.9),
            anisotropy=0.3, clearcoat=0.6, sheen=0.4)),
        make_mesh([0.2, 0.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=D.NormalMap(
            nested=D.GGX(albedo=image(8), roughness=0.3), normals=normals)),
        make_mesh([-0.3, 1.3, 0.9], [0, 0.5, 0], [0.6, 0, 0],
                  bsdf=D.Lambertian(albedo=image(4))),
        make_mesh([0.2, 0.8, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=D.Dielectric()),
    ]
    ball = make_sphere([0.45, 0.35, -0.3], 0.3)
    ball.bsdf = D.NormalMap(
        nested=D.KazenStandard(base_color=image(64), roughness=image(8, 0.1, 0.6)),
        normals=normals)
    extra.append(ball)
    scene = cornell_box(width=width, height=height, spp=1, extra_meshes=extra,
                        regularization=True)
    scene.mip_textures = mip
    scene.aniso_textures = aniso
    return scene


TEXTURED = {"textured": {}, "textured_nomip": {"mip": False},
            "textured_noaniso": {"aniso": False}}


def main(config="4", size=None, device="cuda", sample: int = 0) -> dict:
    """BASELINE config ``config`` (1 to 4), ``mixed`` / ``mixed_single``
    (mixed_scene with and without its sphere), or ``textured`` (and its
    TEXTURED variants: textured_scene), at ``size`` (w, h) where given
    (mixed and textured: 256x256 by default), one pass held; prints a line
    a bounce and returns the summary with the records."""
    from ..examples import baseline_configs as bc
    from ..scene.compiler import compile_scene

    dev = resolve_device(device)
    if str(config).startswith("mixed"):
        desc = mixed_scene(*(size or (256, 256)), sphere=config == "mixed")
    elif config in TEXTURED:
        desc = textured_scene(*(size or (256, 256)), **TEXTURED[config])
    else:
        desc = bc.config_scene(int(config), spp=1)
        if size is not None:
            bc.at_size(desc, *size)
    scene, static = compile_scene(desc, device=dev, megakernel=False)
    res = check_pass(scene, static, sample=sample)
    for r in res["bounces"]:
        print(f"[shade_check] config {config} bounce {r['bounce']} {r['route']} "
              f"(footprint mode {r['footprint_mode']}): "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.3f}); "
              f"differ {dict((k, v) for k, v in r['differ'].items() if v)}")
    out = summary(res)
    out.update(config=config, width=static.width, height=static.height,
               records=res["bounces"])
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="4",
                        help="1 to 4, mixed, mixed_single, or textured[_nomip|_noaniso]")
    parser.add_argument("--size", default=None, help="WxH (default: the config's own)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--json", default=None)
    args = parser.parse_args()
    size = tuple(int(x) for x in args.size.split("x")) if args.size else None
    result = main(args.config, size, args.device)
    print(json.dumps({k: v for k, v in result.items() if k != "records"}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
