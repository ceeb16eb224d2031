"""The path_mis megakernel: a lane's whole NEE+MIS path in one kernel, for
scenes of at most 128 faces.

The port of ``kazen_tpu/integrate/megakernel.py`` (K3, ``_make_kernel``).
It does what ``li_wavefront`` does, per lane and out of on-chip memory:
brute-force trace, punch-through of primary-invisible lights, NEE with an
any-hit shadow ray that such lights never block, MIS, BSDF sampling and
Russian roulette, with the wavefront's draw order, so the two agree lane for
lane up to float rounding.

Two implementations with one contract, ``(tables, cfg, o, d, stream) ->
(6, N)`` rows [li r, li g, li b, rays, Moller-Trumbore tests, bounces]:

* ``megakernel_cuda``: the CUDA kernel in ``csrc/megakernel.cu`` (persistent
  warps whose threads each carry one path and take the next lane when it
  ends, one pass over the scene's faces per vertex, the tables staged in
  shared memory), for tensors on a CUDA device.
* ``megakernel_plain``: the same arithmetic in plain PyTorch over a batch of
  lanes, for CPU tensors and as the kernel's yardstick on the card.

Rows 0-3 of the two are equal bit for bit; rows 4 and 5 count the same work:
F tests for each nearest-hit trace (the punch-through re-cast included), the
faces that can block up to and including the first blocker for each shadow
ray, one bounce for each iteration of a live lane's loop.

The scene class (``supported_reason``) and ``cfg_key`` are the reference's.
The tables are packed for this card: one 16-float geometry record and one
16-float attribute record per face, the materials, the light triangles, the
light CDF and the light radiances. The reference's 8-records-per-row packing
and its unused BVH node table answer Mosaic's tiling and are not carried.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import cuda_build
from ..accel.intersect import Rays, moller_trumbore_edges
from ..cuda_build import CudaKernel
from ..samplers import streams
from ..samplers.streams import SamplerSpec, StreamState
from ..scene.compiler import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_GGX,
    BSDF_KISS,
    BSDF_LAMBERTIAN,
    BSDF_MIRROR,
)

MAX_BRUTE = 128  # faces
MAX_LIGHT_TRIS = 64  # light-triangle slots (lights x their padded face count)
MAX_MATERIALS = 16
GEO_F = 16  # floats per geometry / attribute record
LTRI_F = 32  # floats per light-triangle record
OUT_ROWS = 6  # li rgb, rays, then the kernel's MT tests and bounces
INV_PI = 1.0 / math.pi
BIG = 3.0e38
EPS = 1e-4
MIN_ALPHA = 1e-3
SAMPLER_IDS = {"independent": 0, "stratified": 1, "correlated": 2}
_SUPPORTED_BTYPES = {
    BSDF_DIFFUSE, BSDF_LAMBERTIAN, BSDF_MIRROR, BSDF_DIELECTRIC, BSDF_GGX, BSDF_KISS,
}
# lanes per call of the plain version's body: its brute-force trace holds a
# few dozen (lanes, faces) float tensors
_PLAIN_ELEMS = 1 << 21

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "megakernel.cu")
# no FMA contraction: the kernel then rounds every product and sum as the
# plain version's separate PyTorch operations do
NVCC_FLAGS = ("-fmad=false",)
MEGAKERNEL = CudaKernel("path_mis_megakernel", "kazen_tpu/integrate/megakernel.py:782")
# the kernel's schedule: 1 = persistent warps that refill finished paths, 0 =
# one lane a thread over the full grid; and the instance of
# __launch_bounds__(128, MIN_BLOCKS) of MIN_BLOCKS_CHOICES that runs
# (chip_smoke.py phase 9 times every pair; PERF.md holds the figures)
REFILL = 1
MIN_BLOCKS = 4
MIN_BLOCKS_CHOICES = (1, 2, 3, 4, 5, 6, 8)


@dataclass
class MegaTables:
    geo: torch.Tensor  # (F, 16): [0:3] p0, [3:6] e1, [6:9] e2, [9] material,
    #   [10] light (-1 none), [11] light primary visibility, [12] has_n, [13] has_uv
    attr: torch.Tensor  # (F, 16): [0:9] n0 n1 n2, [9:15] uv0 uv1 uv2
    mats: torch.Tensor  # (M, 16): btype base metallic roughness aniso specular
    #   spec_tint clearcoat cc_rough sheen sheen_tint int_ior ext_ior
    light_tris: torch.Tensor  # (L*maxLF, 32): p0 e1 e2 n0 n1 n2 rad inv_area has_n valid
    light_cdf: torch.Tensor  # (L, maxLF+1) per-light area CDF
    light_info: torch.Tensor  # (max(L, 1), 16): [0:3] radiance, [3] 1/area
    background: Tuple[float, float, float]  # constant background, premultiplied


# ---------------------------------------------------------------------------
# Scene class and packing (host side, at scene-compile time)
# ---------------------------------------------------------------------------


def supported_reason(arrays, static):
    """(ok, reason): is the scene in the megakernel's class?"""
    if static.integrator_kind != "path_mis":
        return False, "integrator is not path_mis"
    if static.sampler_kind not in SAMPLER_IDS:
        return False, f"sampler {static.sampler_kind} unsupported"
    if static.env_importance:
        return False, "env importance sampling enabled"
    if static.has_image_textures or static.has_composite_textures:
        return False, "image/composite textures present"
    if any(t not in _SUPPORTED_BTYPES for t in static.btypes_present):
        return False, "BSDF type outside the supported set"
    nf = int(arrays.F.shape[0])
    if nf > MAX_BRUTE:
        return False, f"{nf} faces > brute-force class ({MAX_BRUTE})"
    if static.num_materials > MAX_MATERIALS:
        return False, f"{static.num_materials} materials > {MAX_MATERIALS}"
    if static.num_lights > 0:
        lf = int(arrays.light_faces.shape[0]) * int(arrays.light_faces.shape[1])
        if lf > MAX_LIGHT_TRIS:
            return False, f"{lf} light tris > {MAX_LIGHT_TRIS}"
    if static.has_background and int(arrays.bg_tex) >= 0:
        return False, "image background texture"
    mt = arrays.materials
    for tex in (mt.tex_base, mt.tex_metallic, mt.tex_roughness, mt.tex_normal):
        if bool((tex >= 0).any()):
            return False, "textured material parameter"
    return True, "supported"


def supported(arrays, static) -> bool:
    return supported_reason(arrays, static)[0]


def cfg_key(arrays, static):
    """The kernel's static configuration as a hashable tuple (the
    reference's, field for field)."""
    L = static.num_lights
    spec = SamplerSpec(
        kind=static.sampler_kind, sample_count=static.sample_count, seed=static.seed
    )
    return (
        ("F", int(arrays.F.shape[0])),
        ("M", static.num_materials),
        ("L", L),
        ("maxLF", int(arrays.light_faces.shape[1]) if L > 0 else 1),
        ("max_depth", static.max_depth),
        ("trace_bias", float(static.trace_bias)),
        ("regularization", bool(static.regularization)),
        ("acc_scale", float(static.accumulated_roughness)),
        ("btypes", tuple(sorted(static.btypes_present))),
        ("needs_punch", L > 0 and bool((~arrays.light_primary_vis[:L]).any())),
        ("has_background", bool(static.has_background)),
        ("sampler", static.sampler_kind),
        ("n", spec.effective_sample_count),
        ("res", spec.resolution),
        ("seed", static.seed),
    )


def pack_tables(arrays, static) -> MegaTables:
    """The megakernel's tables, on the scene's device."""

    def host(t, dtype=np.float32):
        return t.detach().cpu().numpy().astype(dtype)

    face_shade = host(arrays.face_shade)
    fm = host(arrays.face_mesh, np.int64)
    has_n = host(arrays.mesh_has_normals, bool)
    nf = face_shade.shape[0]
    assert nf <= MAX_BRUTE, "supported() keeps larger scenes out"

    geo = np.zeros((nf, GEO_F), np.float32)
    p0 = face_shade[:, 0:3]
    geo[:, 0:3] = p0
    geo[:, 3:6] = face_shade[:, 3:6] - p0
    geo[:, 6:9] = face_shade[:, 6:9] - p0
    geo[:, 9] = host(arrays.mesh_material, np.int64)[fm]
    lid = host(arrays.mesh_light, np.int64)[fm]
    geo[:, 10] = lid
    L = static.num_lights
    if L > 0:
        lpv = host(arrays.light_primary_vis, bool)
        geo[:, 11] = np.where(lid >= 0, lpv[np.maximum(lid, 0)], False)
    geo[:, 12] = has_n[fm]
    geo[:, 13] = host(arrays.mesh_has_uvs, bool)[fm]

    attr = np.zeros((nf, GEO_F), np.float32)
    attr[:, 0:9] = face_shade[:, 9:18]  # n0 n1 n2
    attr[:, 9:15] = face_shade[:, 18:24]  # uv0 uv1 uv2

    mt = arrays.materials
    mats = np.zeros((int(mt.btype.shape[0]), 16), np.float32)
    mats[:, 0] = host(mt.btype)
    mats[:, 1:4] = host(mt.base_color)
    for col, name in enumerate(
        ("metallic", "roughness", "anisotropy", "specular", "specular_tint",
         "clearcoat", "clearcoat_roughness", "sheen", "sheen_tint", "int_ior",
         "ext_ior"),
        start=4,
    ):
        mats[:, col] = host(getattr(mt, name))

    linfo = np.zeros((max(L, 1), 16), np.float32)
    if L > 0:
        lfaces = host(arrays.light_faces, np.int64)[:L]
        maxlf = lfaces.shape[1]
        lrad = host(arrays.light_radiance)[:L]
        linv = host(arrays.light_inv_area)[:L]
        lmesh = host(arrays.light_mesh, np.int64)[:L]
        # padded entries repeat a real face: the CDF walk never picks them
        fs = face_shade[lfaces.reshape(-1)]
        ltris = np.zeros((L * maxlf, LTRI_F), np.float32)
        ltris[:, 0:3] = fs[:, 0:3]
        ltris[:, 3:6] = fs[:, 3:6] - fs[:, 0:3]
        ltris[:, 6:9] = fs[:, 6:9] - fs[:, 0:3]
        ltris[:, 9:18] = fs[:, 9:18]
        ltris[:, 18:21] = np.repeat(lrad, maxlf, axis=0)
        ltris[:, 21] = np.repeat(linv, maxlf)
        ltris[:, 22] = np.repeat(has_n[lmesh], maxlf)
        ltris[:, 23] = 1.0
        lcdf = host(arrays.light_cdf)[:L]
        linfo[:, 0:3] = lrad
        linfo[:, 3] = linv
    else:
        ltris = np.zeros((1, LTRI_F), np.float32)
        lcdf = np.zeros((1, 2), np.float32)

    bg = (0.0, 0.0, 0.0)
    if static.has_background:
        bg = tuple(float(x) for x in (host(arrays.bg_intensity) * host(arrays.bg_color)))

    dev = arrays.face_shade.device

    def dev_t(a):
        return torch.tensor(np.ascontiguousarray(a), device=dev)

    return MegaTables(
        geo=dev_t(geo), attr=dev_t(attr), mats=dev_t(mats), light_tris=dev_t(ltris),
        light_cdf=dev_t(lcdf), light_info=dev_t(linfo), background=bg,
    )


# ---------------------------------------------------------------------------
# The plain version: SoA vec3 helpers (a vector is an (x, y, z) tuple of lane
# tensors), written in the kernel's order of operations
# ---------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _normalize(a):
    return _scale(a, 1.0 / torch.sqrt(torch.clamp(_dot(a, a), min=1e-30)))


def _norm(a):
    return torch.sqrt(torch.clamp(_dot(a, a), min=0.0))


def _where3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _coordinate_system(a):
    """coordinateSystem (common.cpp:434-445)."""
    ax, ay, az = a
    use_x = torch.abs(ax) > torch.abs(ay)
    inv_len_x = 1.0 / torch.sqrt(ax * ax + az * az + 1e-30)
    inv_len_y = 1.0 / torch.sqrt(ay * ay + az * az + 1e-30)
    zero = torch.zeros_like(ax)
    c = _where3(
        use_x, (az * inv_len_x, zero, -ax * inv_len_x), (zero, az * inv_len_y, -ay * inv_len_y)
    )
    return _cross(c, a), c


def _to_local(frame, w):
    s, t, n = frame
    return (_dot(w, s), _dot(w, t), _dot(w, n))


def _to_world(frame, v):
    s, t, n = frame
    return tuple(s[i] * v[0] + t[i] * v[1] + n[i] * v[2] for i in range(3))


def _reflect(wi, n):
    return _sub(_scale(n, 2.0 * _dot(wi, n)), wi)


def _power_heuristic(a, b):
    a2 = a * a
    b2 = b * b
    return torch.where(a2 > 0.0, a2 / (a2 + b2), 0.0)


def _cosine_hemisphere(s0, s1):
    """square_to_cosine_hemisphere (warp.cpp:86-115)."""
    r1 = 2.0 * s0 - 1.0
    r2 = 2.0 * s1 - 1.0
    use_r1 = r1 * r1 > r2 * r2
    r = torch.where(use_r1, r1, r2)
    safe_r1 = torch.where(r1 == 0.0, 1.0, r1)
    safe_r2 = torch.where(r2 == 0.0, 1.0, r2)
    phi = torch.where(
        use_r1, (math.pi / 4.0) * (r2 / safe_r1), (math.pi / 2.0) - (r1 / safe_r2) * (math.pi / 4.0)
    )
    degen = (r1 == 0.0) & (r2 == 0.0)
    r = torch.where(degen, 0.0, r)
    phi = torch.where(degen, 0.0, phi)
    px = r * torch.cos(phi)
    py = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    return (px, py, torch.where(z == 0.0, 1e-10, z))


def _fresnel(cos_i, ext_ior, int_ior):
    """Dielectric Fresnel (common.cpp:447-476)."""
    enter = cos_i >= 0.0
    eta_i = torch.where(enter, ext_ior, int_ior)
    eta_t = torch.where(enter, int_ior, ext_ior)
    ci = torch.abs(cos_i)
    eta = eta_i / eta_t
    sin_t2 = eta * eta * (1.0 - ci * ci)
    ct = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct)
    rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct)
    f = torch.where(sin_t2 > 1.0, 1.0, 0.5 * (rs * rs + rp * rp))
    return torch.where(ext_ior == int_ior, 0.0, f)


# GGX-Smith microfacet (ggx_brdf.h); alpha carried as (ax, ay)


def _r2a(roughness, aniso):
    a = torch.clamp(roughness * roughness, min=MIN_ALPHA)
    return a * (1.0 + aniso), a * (1.0 - aniso)


def _smith_lambda(v, ax, ay):
    vz2 = torch.clamp(v[2] * v[2], min=1e-9)
    sq = (ax * ax * v[0] * v[0] + ay * ay * v[1] * v[1]) / vz2
    return (-1.0 + torch.sqrt(1.0 + sq)) * 0.5


def _smith_g1(v, h, ax, ay):
    g = 1.0 / (1.0 + _smith_lambda(v, ax, ay))
    return torch.where(_dot(v, h) <= 0.0, 0.0, g)


def _smith_g2(v, l, h, ax, ay):
    g = 1.0 / (1.0 + _smith_lambda(v, ax, ay) + _smith_lambda(l, ax, ay))
    return torch.where((_dot(v, h) <= 0.0) | (_dot(l, h) < 0.0), 0.0, g)


def _ggx_ndf(h, ax, ay):
    ell = (h[0] * h[0]) / (ax * ax) + (h[1] * h[1]) / (ay * ay) + h[2] * h[2]
    return 1.0 / (math.pi * ax * ay * ell * ell)


def _vndf(v, h, ax, ay):
    vdoth = _dot(v, h)
    vz = torch.where(v[2] == 0.0, 1e-9, v[2])
    val = _ggx_ndf(h, ax, ay) * _smith_g1(v, h, ax, ay) * vdoth / vz
    return torch.where(vdoth <= 0.0, 0.0, val)


def _sample_vndf(v, ax, ay, u0, u1):
    """sampleGGXSmithVNDF (ggx_brdf.h:96-120)."""
    vh = _normalize((ax * v[0], ay * v[1], v[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-9))
    has = lensq > 0.0
    t1 = (
        torch.where(has, -vh[1] * inv_len, 1.0),
        torch.where(has, vh[0] * inv_len, 0.0),
        torch.zeros_like(vh[0]),
    )
    t2 = _normalize(_cross(vh, t1))
    r = torch.sqrt(u0)
    phi = 2.0 * math.pi * u1
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = _add(_add(_scale(t1, p1), _scale(t2, p2)), _scale(vh, pz))
    return _normalize((ax * nh[0], ay * nh[1], torch.clamp(nh[2], min=1e-6)))


def _schlick3(f0, cos_theta):
    w = torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)
    return tuple(f0[i] + (1.0 - f0[i]) * w for i in range(3))


def _schlick_weight(x):
    x = torch.clamp(1.0 - x, 0.0, 1.0)
    x2 = x * x
    return x2 * x2 * x


def _ggx_eval_pdf(mp, wi, wo):
    """GGX f*cos and pdf of wo (megakernel.py:468-480)."""
    ax, ay = _r2a(mp["roughness"], mp["aniso"])
    h = _normalize(_add(wi, wo))
    sgl = torch.where(
        wi[2] * wo[2] < 0.0,
        0.0,
        _ggx_ndf(h, ax, ay) * _smith_g2(wi, wo, h, ax, ay)
        / torch.clamp(4.0 * torch.abs(wi[2]) * torch.abs(wo[2]), min=1e-9),
    )
    fr = _schlick3(mp["base"], _dot(wi, h))
    jac = 4.0 * _dot(wi, h)
    jac = torch.where(jac == 0.0, 1e-9, jac)
    up = (wi[2] > 0.0) & (wo[2] > 0.0)
    f = tuple(torch.where(up, sgl * fr[i] * wo[2], 0.0) for i in range(3))
    return f, torch.where(up, _vndf(wi, h, ax, ay) / jac, 0.0)


def _kiss_eval_pdf(mp, wi, wo, accum):
    """kiss eval + pdf with shared half-vector and alphas (bsdf.cpp:1226-1299)."""
    v, l = wi, wo
    h = _normalize(_add(v, l))
    base = mp["base"]
    metallic = mp["metallic"]
    roughness = torch.clamp(mp["roughness"] + accum, max=1.0)
    ax, ay = _r2a(roughness, mp["aniso"])
    cc_rough = mp["cc_rough"] * (0.3 - 0.01) + 0.01
    cax, cay = _r2a(cc_rough, mp["aniso"])
    pax, pay = _r2a(cc_rough, torch.zeros_like(mp["aniso"]))

    cdlum = 0.212671 * base[0] + 0.715160 * base[1] + 0.072169 * base[2]
    pos = cdlum > 0.0
    inv_lum = 1.0 / torch.clamp(cdlum, min=1e-9)
    ctint = tuple(torch.where(pos, base[i] * inv_lum, 1.0) for i in range(3))
    spec08 = 0.08 * mp["specular"]
    st = mp["spec_tint"]
    ctintmix = tuple(spec08 * (st + (1.0 - st) * ctint[i]) for i in range(3))
    cspec0 = tuple(ctintmix[i] + metallic * (base[i] - ctintmix[i]) for i in range(3))
    fl = _schlick_weight(l[2])
    fv = _schlick_weight(v[2])
    fh = _schlick_weight(_dot(l, h))
    cos_d = _dot(v, h)
    lambert = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    rr = 2.0 * roughness * cos_d * cos_d
    retro = rr * (fl + fv + fl * fv * (rr - 1.0))
    sht = mp["sheen_tint"]
    sheen_s = fh * mp["sheen"]
    fsheen = tuple(sheen_s * (sht + (1.0 - sht) * ctint[i]) for i in range(3))

    denom = torch.clamp(4.0 * torch.abs(v[2]) * torch.abs(l[2]), min=1e-9)
    opp = v[2] * l[2] < 0.0
    sg = torch.where(opp, 0.0, _ggx_ndf(h, ax, ay) * _smith_g2(v, l, h, ax, ay) / denom)
    f_spec = _schlick3(cspec0, cos_d)
    cg = torch.where(opp, 0.0, _ggx_ndf(h, cax, cay) * _smith_g2(v, l, h, cax, cay) / denom)
    f04 = torch.full_like(cos_d, 0.04)
    f_cc = _schlick3((f04, f04, f04), cos_d)
    cc_s = 0.25 * mp["clearcoat"]
    val = tuple(
        (
            (1.0 - metallic) * (base[i] * INV_PI * (lambert + retro) + fsheen[i])
            + sg * f_spec[i]
            + cc_s * cg * f_cc[i]
        )
        * l[2]
        for i in range(3)
    )

    diffuse_p = (1.0 - metallic) * 0.5
    gtr2 = 1.0 / (1.0 + mp["clearcoat"])
    jac = 4.0 * _dot(wi, h)
    jac = torch.where(jac == 0.0, 1e-9, jac)
    spec_pdf = _vndf(wi, h, ax, ay) / jac
    coat_pdf = _vndf(wi, h, pax, pay) / jac
    pdf = diffuse_p * INV_PI * l[2] + (1.0 - diffuse_p) * (
        gtr2 * spec_pdf + (1.0 - gtr2) * coat_pdf
    )
    m = (wi[2] > 0.0) & (wo[2] > 0.0)
    return tuple(torch.where(m, c, 0.0) for c in val), torch.where(m, pdf, 0.0)


def _kiss_sample(mp, wi, s1, s2a, s2b, accum):
    """kiss sample (bsdf.cpp:1301-1370): (wo, weight, pdf)."""
    diffuse = (1.0 - mp["metallic"]) * 0.5
    gtr2 = 1.0 / (1.0 + mp["clearcoat"])
    wo_diff = _cosine_hemisphere(s2a, s2b)
    s_rescaled = (s1 - diffuse) / torch.clamp(1.0 - diffuse, min=1e-9)
    flip = wi[2] <= 0.0
    wi_f = _where3(flip, _neg(wi), wi)
    # the half-vector uses the unregularized roughness (bsdf.cpp:1317)
    ax_s, ay_s = _r2a(mp["roughness"], mp["aniso"])
    cc_rough = mp["cc_rough"] * (0.3 - 0.01) + 0.01
    ax_c, ay_c = _r2a(cc_rough, torch.zeros_like(mp["aniso"]))
    use_spec = s_rescaled < gtr2
    h = _sample_vndf(
        wi_f, torch.where(use_spec, ax_s, ax_c), torch.where(use_spec, ay_s, ay_c), s2a, s2b
    )
    h = _where3(flip, _neg(h), h)
    wo = _where3(s1 < diffuse, wo_diff, _normalize(_reflect(wi, h)))
    val, pdf = _kiss_eval_pdf(mp, wi, wo, accum)
    inv_pdf = 1.0 / torch.clamp(pdf, min=1e-9)
    ok = (wi[2] > 0.0) & (wo[2] > 0.0) & (pdf > EPS)
    for c in wo:
        ok = ok & torch.isfinite(c)
    w = tuple(torch.where(ok & torch.isfinite(c * inv_pdf), c * inv_pdf, 0.0) for c in val)
    return wo, w, pdf


def _bsdf_eval_pdf(btypes, mp, wi, wo, accum):
    """(f*cos, pdf) dispatched over the scene's material types."""
    zero = torch.zeros_like(wi[0])
    out_f, out_p = (zero, zero, zero), zero
    up = (wi[2] > 0.0) & (wo[2] > 0.0)
    for t in btypes:
        if t in (BSDF_DIFFUSE, BSDF_LAMBERTIAN):
            p = torch.where(up, INV_PI * wo[2], 0.0)
            f = tuple(torch.where(up, mp["base"][i] * INV_PI * wo[2], 0.0) for i in range(3))
        elif t in (BSDF_MIRROR, BSDF_DIELECTRIC):
            f, p = (zero, zero, zero), zero
        elif t == BSDF_GGX:
            f, p = _ggx_eval_pdf(mp, wi, wo)
        else:
            f, p = _kiss_eval_pdf(mp, wi, wo, accum)
        sel = mp["btype"] == t
        out_f = _where3(sel, f, out_f)
        out_p = torch.where(sel, p, out_p)
    return out_f, out_p


def _bsdf_sample(btypes, mp, wi, s1, s2a, s2b, accum):
    """BSDF sample dispatched over the scene's material types: (wo, weight,
    eta, discrete, pdf)."""
    zero = torch.zeros_like(wi[0])
    one = torch.ones_like(wi[0])
    no = torch.zeros_like(wi[0], dtype=torch.bool)
    out = ((zero, zero, zero), (zero, zero, zero), one, no, zero)
    for t in btypes:
        eta, disc, pdf = one, no, zero
        if t in (BSDF_DIFFUSE, BSDF_LAMBERTIAN):
            wo = _cosine_hemisphere(s2a, s2b)
            w = tuple(torch.where(wi[2] > 0.0, mp["base"][i], 0.0) for i in range(3))
            pdf = torch.where((wi[2] > 0.0) & (wo[2] > 0.0), INV_PI * wo[2], 0.0)
        elif t == BSDF_MIRROR:
            wo = (-wi[0], -wi[1], wi[2])
            w = (torch.where(wi[2] > 0.0, 1.0, 0.0),) * 3
            disc = ~no
        elif t == BSDF_DIELECTRIC:
            cos_i = wi[2]
            fr = _fresnel(cos_i, mp["ext_ior"], mp["int_ior"])
            outside = cos_i >= 0.0
            nz = torch.where(outside, 1.0, -1.0)
            factor = torch.where(
                outside, mp["int_ior"] / mp["ext_ior"], mp["ext_ior"] / mp["int_ior"]
            )
            # refract(-wi, n, factor) with n = (0, 0, nz)
            ci = -wi[2] * nz
            eta_eff = torch.where(ci < 0.0, 1.0 / factor, factor)
            cos_t2 = 1.0 - (1.0 - ci * ci) * (eta_eff * eta_eff)
            sign = torch.where(ci >= 0.0, 1.0, -1.0)
            root = torch.sqrt(torch.clamp(cos_t2, min=0.0))
            tir = cos_t2 <= 0.0
            refr = (
                torch.where(tir, 0.0, -wi[0] * eta_eff),
                torch.where(tir, 0.0, -wi[1] * eta_eff),
                torch.where(tir, 0.0, nz * (-ci * eta_eff + sign * root) + -wi[2] * eta_eff),
            )
            choose = s1 < fr
            wo = _where3(choose, (-wi[0], -wi[1], wi[2]), refr)
            eta = torch.where(choose, 1.0, mp["int_ior"] / mp["ext_ior"])
            w = (one, one, one)
            disc = ~no
        elif t == BSDF_GGX:
            ax, ay = _r2a(mp["roughness"], mp["aniso"])
            wo = _reflect(wi, _sample_vndf(wi, ax, ay, s2a, s2b))
            f, pdf = _ggx_eval_pdf(mp, wi, wo)
            inv_pdf = 1.0 / torch.clamp(pdf, min=1e-9)
            okg = (wi[2] > 0.0) & (wo[2] > 0.0) & (pdf > 0.0)
            w = tuple(torch.where(okg, f[i] * inv_pdf, 0.0) for i in range(3))
        else:
            wo, w, pdf = _kiss_sample(mp, wi, s1, s2a, s2b, accum)
        sel = mp["btype"] == t
        out = (
            _where3(sel, wo, out[0]), _where3(sel, w, out[1]),
            torch.where(sel, eta, out[2]), torch.where(sel, disc, out[3]),
            torch.where(sel, pdf, out[4]),
        )
    return out


# ---------------------------------------------------------------------------
# The plain version: trace, shading prep and the path loop
# ---------------------------------------------------------------------------


def _face_test(tables, o, d):
    """Moller-Trumbore of every lane against every face: (n, F) (t, u, v, ok)."""
    g = tables.geo
    return moller_trumbore_edges(
        torch.stack(o, -1)[:, None], torch.stack(d, -1)[:, None],
        g[None, :, 0:3], g[None, :, 3:6], g[None, :, 6:9],
    )


def _trace(tables, o, d, mint) -> dict:
    """Nearest hit as the per-lane record found, u, v, p0, e1, e2, n0, n1,
    n2, uv0, uv1, uv2, mat, light, light_pv, has_n, has_uv (the reference's,
    with bool flags and int64 ids). Of faces at the same t the first in face
    order wins (the kernel's strict ``t < best``); missed lanes carry the
    reference's empty record (zeros, light -1)."""
    t, u, v, ok = _face_test(tables, o, d)
    tm = torch.where(ok & (t >= mint), t, math.inf)
    best = tm.argmin(dim=1)
    found = tm.gather(1, best[:, None])[:, 0] < BIG
    f = found[:, None]
    g = torch.where(f, tables.geo[best], 0.0)
    a = torch.where(f, tables.attr[best], 0.0)

    def vec(rows, c):
        return (rows[:, c], rows[:, c + 1], rows[:, c + 2])

    return dict(
        found=found,
        u=torch.where(found, u.gather(1, best[:, None])[:, 0], 0.0),
        v=torch.where(found, v.gather(1, best[:, None])[:, 0], 0.0),
        p0=vec(g, 0), e1=vec(g, 3), e2=vec(g, 6),
        n0=vec(a, 0), n1=vec(a, 3), n2=vec(a, 6),
        uv0=(a[:, 9], a[:, 10]), uv1=(a[:, 11], a[:, 12]), uv2=(a[:, 13], a[:, 14]),
        mat=g[:, 9].to(torch.int64),
        light=torch.where(found, g[:, 10], -1.0).to(torch.int64),
        light_pv=g[:, 11] > 0.0, has_n=g[:, 12] > 0.0, has_uv=g[:, 13] > 0.0,
    )


def _occluded(tables, o, d, mint, maxt):
    """(blocked, tests): any hit in [mint, maxt], where faces of
    primary-invisible lights never block (the single-pass form of
    integrator.cpp:259-278), and the faces that can block up to and
    including the first blocker (all of them where none blocks), the tests
    a walk in face order that stops at its first blocker makes."""
    t, _, _, ok = _face_test(tables, o, d)
    g = tables.geo
    can_block = ~((g[:, 10] >= 0.0) & (g[:, 11] == 0.0))
    hits = ok & (t >= mint) & (t <= maxt[:, None]) & can_block[None, :]
    blocked = hits.any(dim=1)
    first = torch.where(blocked, hits.to(torch.int32).argmax(dim=1), hits.shape[1] - 1)
    return blocked, torch.cumsum(can_block.to(torch.int64), 0)[first]


def _select_hit(take, a: dict, b: dict) -> dict:
    return {
        k: _where3(take, a[k], b[k]) if isinstance(a[k], tuple) else torch.where(take, a[k], b[k])
        for k in a
    }


def _hanika_point(hit):
    """The hit point with Hanika's terminator offset (accel.cpp:141-153);
    the plain point without vertex normals."""
    b0 = 1.0 - hit["u"] - hit["v"]
    b1, b2 = hit["u"], hit["v"]
    p0 = hit["p0"]
    p1 = _add(p0, hit["e1"])
    p2 = _add(p0, hit["e2"])
    orig_p = _add(_add(_scale(p0, b0), _scale(p1, b1)), _scale(p2, b2))
    tmp = []
    for pv, nv in ((p0, hit["n0"]), (p1, hit["n1"]), (p2, hit["n2"])):
        tv = _sub(orig_p, pv)
        tmp.append(_sub(tv, _scale(nv, torch.clamp(_dot(tv, nv), max=0.0))))
    p_han = _add(orig_p, _add(_add(_scale(tmp[0], b0), _scale(tmp[1], b1)), _scale(tmp[2], b2)))
    return _where3(hit["has_n"], p_han, orig_p)


def _prep(hit):
    """Post-hit shading prep (accel.cpp:113-236): (p, frame (s, t, n))."""
    p = _hanika_point(hit)
    b0 = 1.0 - hit["u"] - hit["v"]
    b1, b2 = hit["u"], hit["v"]
    cr = _cross(hit["e1"], hit["e2"])
    gn = _normalize(cr)
    cross_len = _norm(cr)
    shn_raw = _add(_add(_scale(hit["n0"], b0), _scale(hit["n1"], b1)), _scale(hit["n2"], b2))
    sh_n = _normalize(shn_raw)
    uv0, uv1, uv2 = hit["uv0"], hit["uv1"], hit["uv2"]
    duv0x = uv1[0] - uv0[0]
    duv0y = uv1[1] - uv0[1]
    duv1x = uv2[0] - uv0[0]
    duv1y = uv2[1] - uv0[1]
    determinant = duv0x * duv1y - duv0y * duv1x
    uv_ok = hit["has_n"] & hit["has_uv"] & (cross_len > 0.0) & (determinant > 0.0)
    inv_det = 1.0 / torch.where(determinant != 0.0, determinant, 1.0)
    dpdu = _scale(_sub(_scale(hit["e1"], duv1y), _scale(hit["e2"], duv0y)), inv_det)
    s_uv = _normalize(_sub(dpdu, _scale(shn_raw, _dot(shn_raw, dpdu))))
    t_uv = _normalize(_cross(sh_n, s_uv))
    n_fb = _where3(hit["has_n"], sh_n, gn)
    fb_s, fb_t = _coordinate_system(n_fb)
    frame = (_where3(uv_ok, s_uv, fb_s), _where3(uv_ok, t_uv, fb_t), _where3(uv_ok, sh_n, n_fb))
    return p, frame


def _light_of(tables, light):
    """Radiance and 1/area of each lane's light id (0 where it is none)."""
    is_light = light >= 0
    row = tables.light_info[torch.clamp(light, min=0)]
    rad = tuple(torch.where(is_light, row[:, i], 0.0) for i in range(3))
    return rad, torch.where(is_light, row[:, 3], 0.0)


def _material(tables, mat):
    r = tables.mats[mat]
    return dict(
        btype=r[:, 0].to(torch.int64), base=(r[:, 1], r[:, 2], r[:, 3]), metallic=r[:, 4],
        roughness=r[:, 5], aniso=r[:, 6], specular=r[:, 7], spec_tint=r[:, 8],
        clearcoat=r[:, 9], cc_rough=r[:, 10], sheen=r[:, 11], sheen_tint=r[:, 12],
        int_ior=r[:, 13], ext_ior=r[:, 14],
    )


def _sample_light(tables, cfg, p, u_pick, u_tri, u_a, u_b):
    """Uniform light pick, CDF triangle pick and the sqrt warp onto it
    (scene.h:45-53, mesh.cpp:108-133): (wi, dist, pdf, Le/pdf)."""
    L, maxlf = cfg["L"], cfg["maxLF"]
    pick = torch.clamp(torch.floor(L * u_pick), 0.0, float(L - 1)).to(torch.int64)
    cdf = tables.light_cdf[pick]
    tri = (u_tri[:, None] >= cdf[:, 1:maxlf]).sum(dim=1)
    r = tables.light_tris[pick * maxlf + tri]

    def vec(c):
        return (r[:, c], r[:, c + 1], r[:, c + 2])

    su0 = torch.sqrt(u_a)
    wu = 1.0 - su0
    wv = u_b * su0
    p0, e1, e2, n0 = vec(0), vec(3), vec(6), vec(9)
    lp = _add(_add(p0, _scale(e1, wu)), _scale(e2, wv))
    n_interp = _add(n0, _add(_scale(_sub(vec(12), n0), wu), _scale(_sub(vec(15), n0), wv)))
    ln = _where3(r[:, 22] > 0.0, n_interp, _normalize(_cross(e1, e2)))
    to_l = _sub(lp, p)
    dist = _norm(to_l)
    wi = _scale(to_l, 1.0 / torch.clamp(dist, min=1e-9))
    cos_th = _dot(ln, _neg(wi))
    pdf = torch.where(
        cos_th > 0.0, r[:, 21] * dist * dist / torch.clamp(cos_th, min=1e-9), 0.0
    )
    valid = (pdf > 0.0) & torch.isfinite(pdf) & (cos_th > 0.0)
    inv_pdf = 1.0 / torch.clamp(pdf, min=1e-9)
    ls = tuple(torch.where(valid, r[:, 18 + i] * inv_pdf, 0.0) for i in range(3))
    return wi, dist, pdf, ls


def _path_plain(tables, cfg, spec, o, d, st: StreamState) -> torch.Tensor:
    """The kernel's body over a batch of lanes: (OUT_ROWS, n) rows."""
    n = o[0].shape[0]
    L = cfg["L"]
    bias = cfg["trace_bias"]
    btypes = cfg["btypes"]
    F = cfg["F"]
    hit = _trace(tables, o, d, EPS)
    tests = torch.full_like(o[0], F, dtype=torch.int64)
    bounces = torch.zeros_like(tests)
    if cfg["needs_punch"]:
        # camera-ray punch-through of primary-invisible lights
        # (integrator.cpp:213-220); a missed re-cast keeps the light hit
        punch = hit["found"] & (hit["light"] >= 0) & ~hit["light_pv"]
        hit2 = _trace(tables, _add(_hanika_point(hit), _scale(d, bias)), d, EPS)
        hit = _select_hit(punch & hit2["found"], hit2, hit)
        tests = tests + F * punch.to(torch.int64)
    rad, inv_area = _light_of(tables, hit["light"])
    p, frame = _prep(hit)
    mat, light = hit["mat"], hit["light"]

    zero = torch.zeros_like(o[0])
    li = [zero, zero, zero]
    tpt = [zero + 1.0, zero + 1.0, zero + 1.0]
    eta = zero + 1.0
    bw = zero + 1.0  # MIS weight of an emitter hit (1 for the camera "lobe")
    accum = zero
    alive = hit["found"]
    nrays = zero + 1.0  # the primary ray
    for depth in range(cfg["max_depth"]):
        if not bool(alive.any()):
            break
        bounces = bounces + alive.to(torch.int64)
        wi = _to_local(frame, _neg(d))
        mp = _material(tables, mat)

        # (1) an emitter hit ends the lane (integrator.cpp:226-231)
        hit_light = alive & (light >= 0)
        cos_l = _dot(frame[2], _neg(_normalize(_sub(p, o))))
        for i in range(3):
            li[i] = li[i] + torch.where(hit_light & (cos_l > 0.0), bw * tpt[i] * rad[i], 0.0)
        alive = alive & ~hit_light

        # (2) Russian roulette from depth 3 (integrator.cpp:237-244)
        if depth >= 3:
            st, u_rr = streams.next_1d(spec, st)
            prob = torch.clamp(torch.maximum(torch.maximum(tpt[0], tpt[1]), tpt[2]) * eta * eta, max=0.95)
            alive = alive & ~(prob <= u_rr)
            rr_scale = torch.where(alive, 1.0 / torch.clamp(prob, min=1e-9), 1.0)
            tpt = [c * rr_scale for c in tpt]

        # (3) NEE with MIS (integrator.cpp:247-294)
        if L > 0:
            st, u_pick = streams.next_1d(spec, st)
            st, u_tri = streams.next_1d(spec, st)
            st, u_a = streams.next_1d(spec, st)
            st, u_b = streams.next_1d(spec, st)
            nee_wi, dist, nee_pdf, ls = _sample_light(tables, cfg, p, u_pick, u_tri, u_a, u_b)
            f_nee, pdf_b = _bsdf_eval_pdf(btypes, mp, wi, _to_local(frame, nee_wi), accum)
            w_light = _power_heuristic(nee_pdf, pdf_b)
            # Ls *= numLights (scene.h:56: the pick's pdf is 1/numLights)
            cch = [tpt[i] * ls[i] * float(L) * f_nee[i] * w_light for i in range(3)]
            # only a shadow ray that can add light is traced and counted
            shadow = alive & ((cch[0] != 0.0) | (cch[1] != 0.0) | (cch[2] != 0.0))
            occ, occ_tests = _occluded(tables, p, nee_wi, bias, dist - bias)
            for i in range(3):
                li[i] = li[i] + torch.where(shadow & ~occ, cch[i], 0.0)
            nrays = nrays + shadow.to(torch.float32)
            tests = tests + torch.where(shadow, occ_tests, 0)

        # (4) roughness regularization (integrator.cpp:297-301)
        if cfg["regularization"]:
            reg = torch.where(mp["btype"] == BSDF_KISS, mp["roughness"], 0.0)
            accum = torch.where(alive, accum + reg * cfg["acc_scale"], accum)

        # (5) BSDF sample (integrator.cpp:303-309)
        st, s1 = streams.next_1d(spec, st)
        st, s2 = streams.next_2d(spec, st)
        wo, w, s_eta, disc, bsdf_pdf = _bsdf_sample(
            btypes, mp, wi, s1, s2[:, 0], s2[:, 1], accum
        )
        tpt = [torch.where(alive, tpt[i] * w[i], tpt[i]) for i in range(3)]
        eta = torch.where(alive, eta * s_eta, eta)
        alive = alive & ((w[0] > 0.0) | (w[1] > 0.0) | (w[2] > 0.0))

        # (6) trace the BSDF ray; a miss sees the background (:312-331)
        new_d = _to_world(frame, wo)
        hit = _trace(tables, p, new_d, bias)
        nrays = nrays + alive.to(torch.float32)
        tests = tests + F * alive.to(torch.int64)
        if cfg["has_background"]:
            missed = alive & ~hit["found"]
            for c in new_d:
                missed = missed & torch.isfinite(c)
            for i in range(3):
                li[i] = li[i] + torch.where(missed, tpt[i] * tables.background[i], 0.0)
        alive = alive & hit["found"]
        new_rad, new_inv_area = _light_of(tables, hit["light"])
        new_p, new_frame = _prep(hit)

        # the MIS weight an emitter hit by this ray gets (1 after a discrete lobe)
        to_p = _sub(new_p, p)
        dist_n = _norm(to_p)
        cos_n = _dot(new_frame[2], _neg(_scale(to_p, 1.0 / torch.clamp(dist_n, min=1e-9))))
        lpdf = torch.where(
            cos_n > 0.0, new_inv_area * dist_n * dist_n / torch.clamp(cos_n, min=1e-9), 0.0
        )
        bw = torch.where(alive & (hit["light"] >= 0), _power_heuristic(bsdf_pdf, lpdf), bw)
        bw = torch.where(disc, 1.0, bw)

        o = _where3(alive, p, o)
        d = _where3(alive, new_d, d)
        p = _where3(alive, new_p, p)
        frame = tuple(_where3(alive, a, b) for a, b in zip(new_frame, frame))
        mat = torch.where(alive, hit["mat"], mat)
        light = torch.where(alive, hit["light"], light)
        rad = _where3(alive, new_rad, rad)

    out = torch.zeros((OUT_ROWS, n), dtype=torch.float32, device=o[0].device)
    out[0:3] = torch.stack(li)
    out[3] = nrays
    out[4] = tests.to(torch.float32)
    out[5] = bounces.to(torch.float32)
    return out


def _spec(cfg) -> SamplerSpec:
    """The sampler of ``cfg``: a spec whose sample count is the effective one
    has the same strata as the scene's."""
    spec = SamplerSpec(kind=cfg["sampler"], sample_count=cfg["n"], seed=cfg["seed"])
    assert spec.effective_sample_count == cfg["n"] and spec.resolution == tuple(cfg["res"])
    return spec


def megakernel_plain(tables: MegaTables, cfg, o, d, stream: StreamState) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: o, d (N, 3), the lanes'
    streams -> (6, N) rows. Lanes run in batches that keep the brute-force
    trace's (lanes, faces) tensors small."""
    cfg = dict(cfg)
    spec = _spec(cfg)
    n = o.shape[0]
    out = torch.zeros((OUT_ROWS, n), dtype=torch.float32, device=o.device)
    step = max(1, _PLAIN_ELEMS // cfg["F"])
    for s in range(0, n, step):
        e = min(n, s + step)
        out[:, s:e] = _path_plain(
            tables, cfg, spec, tuple(o[s:e].unbind(-1)), tuple(d[s:e].unbind(-1)),
            stream.index(slice(s, e)),
        )
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """``struct Params`` of csrc/megakernel.cu, field for field."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "o", "d", "st_state", "st_inc", "st_dim", "st_px", "st_py", "st_idx",
            "geo", "attr", "mats", "ltris", "lcdf", "linfo", "out", "next_lane", "slots",
        )
    ] + [("seed", ctypes.c_uint64)] + [
        (name, ctypes.c_int)
        for name in (
            "n", "F", "M", "L", "max_lf", "max_depth", "needs_punch", "regularization",
            "has_background", "sampler", "samp_n", "res_x", "res_y", "refill", "min_blocks",
        )
    ] + [
        (name, ctypes.c_float)
        for name in ("trace_bias", "acc_scale", "bg_r", "bg_g", "bg_b")
    ]


def build_library() -> "tuple[str, str]":
    """Compile csrc/megakernel.cu for sm_90a into the build directory (once
    per source hash). Returns (library path, compiler output)."""
    return cuda_build.build_library(SOURCE, "libkazen_megakernel", NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    lib.kz_megakernel.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    lib.kz_megakernel.restype = ctypes.c_int
    lib.kz_megakernel_info.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(ctypes.c_int)]
    lib.kz_megakernel_info.restype = ctypes.c_int
    lib.kz_error_string.argtypes = [ctypes.c_int]
    lib.kz_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name} must be {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _params(tables: MegaTables, cfg: dict, n: int, pointers, refill: int, min_blocks: int):
    """The kernel's Params: ``pointers`` are the data pointers of o, d, the
    six stream fields, out, the refill counter and the lane-slot counters."""
    res_x, res_y = cfg["res"]
    *inputs, out, next_lane, slots = pointers
    return _Params(
        *inputs,
        *(t.data_ptr() for t in (
            tables.geo, tables.attr, tables.mats, tables.light_tris, tables.light_cdf,
            tables.light_info,
        )),
        out, next_lane, slots,
        cfg["seed"] & (2**64 - 1),
        n, cfg["F"], cfg["M"], cfg["L"], cfg["maxLF"], cfg["max_depth"],
        int(cfg["needs_punch"]), int(cfg["regularization"]), int(cfg["has_background"]),
        SAMPLER_IDS[cfg["sampler"]], cfg["n"], res_x, res_y, refill, min_blocks,
        cfg["trace_bias"], cfg["acc_scale"], *tables.background,
    )


def kernel_info(tables: MegaTables, cfg, min_blocks: int = MIN_BLOCKS) -> dict:
    """Registers and local-memory bytes (spills and stack) a thread of the
    kernel instance for ``cfg``'s sampler and ``min_blocks``, and the blocks
    of it an SM holds with ``tables`` staged, on the current CUDA device."""
    info = (ctypes.c_int * 3)()
    prm = _params(tables, dict(cfg), 1, (None,) * 11, REFILL, min_blocks)
    lib = _library()
    code = lib.kz_megakernel_info(ctypes.byref(prm), info)
    if code != 0:
        raise RuntimeError(f"kz_megakernel_info failed: {lib.kz_error_string(code).decode()}")
    return {"regs": info[0], "local_bytes": info[1], "blocks_per_sm": info[2]}


def megakernel_cuda(
    tables: MegaTables, cfg, o, d, stream: StreamState, refill: int = REFILL,
    min_blocks: int = MIN_BLOCKS, slots=None,
) -> torch.Tensor:
    """The K3 kernel: o, d (N, 3) float32 and the lanes' streams on a CUDA
    device -> (6, N) rows. ``refill`` and ``min_blocks`` pick the schedule
    and the instance (the rows do not depend on them); where ``slots`` is an
    int64 (2,) tensor on the device, the launch's lane-slot counts (32 x the
    warps' iterations, the threads that held a path in them) are added to
    it."""
    cfg = dict(cfg)
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the megakernel takes CUDA tensors, got {dev}")
    n = o.shape[0]
    if n >= 2**31:
        raise ValueError("too many lanes for one launch")
    if refill not in (0, 1) or min_blocks not in MIN_BLOCKS_CHOICES:
        raise ValueError(f"no kernel for refill {refill}, min_blocks {min_blocks}")
    F, M, L, maxlf = cfg["F"], cfg["M"], cfg["L"], cfg["maxLF"]
    _check("o", o, torch.float32, (n, 3), dev)
    _check("d", d, torch.float32, (n, 3), dev)
    for name in StreamState._fields:
        _check(f"stream.{name}", getattr(stream, name), torch.int64, (n,), dev)
    _check("tables.geo", tables.geo, torch.float32, (F, GEO_F), dev)
    _check("tables.attr", tables.attr, torch.float32, (F, GEO_F), dev)
    _check("tables.mats", tables.mats, torch.float32, (M, 16), dev)
    _check("tables.light_tris", tables.light_tris, torch.float32, (max(L * maxlf, 1), LTRI_F), dev)
    _check("tables.light_cdf", tables.light_cdf, torch.float32, (max(L, 1), maxlf + 1), dev)
    _check("tables.light_info", tables.light_info, torch.float32, (max(L, 1), 16), dev)
    if slots is not None:
        _check("slots", slots, torch.int64, (2,), dev)
    out = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    # the refill counter (int32 0) and the two uint64 lane-slot counters
    # (int32 2-5, 8-byte aligned) in one zeroed scratch tensor
    scratch = torch.zeros(6, dtype=torch.int32, device=dev)
    prm = _params(
        tables, cfg, n,
        (*(t.data_ptr() for t in (o, d, *stream, out)), scratch.data_ptr(),
         scratch.data_ptr() + 8),
        refill, min_blocks,
    )
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.kz_megakernel(ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    MEGAKERNEL.launches += 1
    if code != 0:
        raise RuntimeError(
            f"{MEGAKERNEL.name} launch failed: {lib.kz_error_string(code).decode()} ({code})"
        )
    if slots is not None:
        slots += scratch[2:].view(torch.int64)
    return out


def megakernel(tables: MegaTables, cfg, o, d, stream: StreamState) -> torch.Tensor:
    """(6, N) rows: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if o.device.type == "cuda":
        return megakernel_cuda(tables, cfg, o, d, stream)
    if o.device.type == "cpu":
        return megakernel_plain(tables, cfg, o, d, stream)
    raise ValueError(f"unsupported device {o.device}")


def li_megakernel(scene, static, spec, stream: StreamState, rays: Rays):
    """Integrator::Li over a lane batch through the megakernel, for a scene
    in its class: (stream, li (N, 3), rays traced), as li_wavefront returns
    them. The stream comes back unchanged, as the reference's does."""
    tables = scene.mega if scene.mega is not None else pack_tables(scene, static)
    cfg = static.mega_cfg if static.mega_cfg is not None else cfg_key(scene, static)
    out = megakernel(
        tables, cfg, rays.o.contiguous(), rays.d.contiguous(),
        StreamState(*(f.contiguous() for f in stream)),
    )
    return stream, out[0:3].T, out[3].sum(dtype=torch.float64)
