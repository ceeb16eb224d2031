"""A bounce's shade stage in one CUDA launch: from the trace kernel K1's
rows to the columns the ordered permute gathers.

``integrate/path_mis.py:_bounce_ordered`` shades a bounce either with
``_shade_plain`` (plain PyTorch: the shade prep from the rows, the emitter
hit, Russian roulette, NEE, the regularization and the BSDF sample, each
material type's branch on every lane) or with the kernel of
``csrc/bounce.cu`` (one thread a lane, each lane evaluating its own lobe
only), with one contract: ``ShadeOut``. The route adapts to what the scene
and the call show (``route_reason``): the kernel for CUDA tensors of a scene
in its class outside autograd, the plain version otherwise. On the kernel
route a CUDA tensor launches the kernel or raises.

The kernel reads the material rows and the light tables packed here
(``pack_tables``), once per compiled scene (``SceneArrays.shade_tables``),
with torch operations on the scene's device; a scene whose material or
light tensors were replaced or changed in place since is packed again.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch

from .. import cuda_build
from ..cuda_build import CudaKernel
from ..scene.compiler import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_GGX,
    BSDF_KISS,
    BSDF_LAMBERTIAN,
    BSDF_MIRROR,
    BSDF_NORMALMAP,
)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "bounce.cu")
# every product and sum rounds on its own, as the plain version's ops do
NVCC_FLAGS = ("-fmad=false",)
SUPPORTED_BTYPES = (
    BSDF_DIFFUSE, BSDF_DIELECTRIC, BSDF_MIRROR, BSDF_LAMBERTIAN, BSDF_GGX, BSDF_KISS,
)
OUT_COLS = 24  # [p 3, nee_wi 3, smaxt, pd 3, li 3, throughput 3, eta, accum, contrib 3,
#                 bsdf_pdf, discrete, alive]
MAT_F = 16  # [btype, base 3, then MAT_FIELDS, 0]
MAT_FIELDS = ("metallic", "roughness", "anisotropy", "specular", "specular_tint", "clearcoat",
              "clearcoat_roughness", "sheen", "sheen_tint", "int_ior", "ext_ior")
LTRI_F = 18  # a light triangle's face_shade[:, 0:18]: [p0 p1 p2 n0 n1 n2]
LINFO_F = 8  # a light's [radiance 3, inv_area, has_normals, 0, 0, 0]

# replaces no TPU kernel: kazen_tpu's bounce body is XLA-fused elementwise code
SHADE = CudaKernel("shade_bounce", "none (kazen_tpu/integrate/path_mis.py, XLA-fused bounce)")


class Draws(NamedTuple):
    """A bounce's uniforms, drawn at its head in the reference's order: RR
    (None before depth 3), the light pick, triangle and warp pair (None
    without lights), the BSDF's s1 and s2 (N, 2)."""

    u_rr: Optional[torch.Tensor]
    u_pick: Optional[torch.Tensor]
    u_tri: Optional[torch.Tensor]
    u_a: Optional[torch.Tensor]
    u_b: Optional[torch.Tensor]
    s1: torch.Tensor
    s2: torch.Tensor


class ShadeOut(NamedTuple):
    """The shade stage's outputs, in the lane order of its input: the
    permute's columns, the light pick and hit cluster (int64, for the
    packet key) and the bounce's shadow-ray and path-ray counts (f32
    scalars). ``packed`` is the kernel's (N, 24) tensor whose column views
    the float fields are (None from the plain version)."""

    p: torch.Tensor
    nee_wi: torch.Tensor
    smaxt: torch.Tensor
    pd: torch.Tensor
    li: torch.Tensor
    throughput: torch.Tensor
    eta: torch.Tensor
    accum: torch.Tensor
    contrib: torch.Tensor
    bsdf_pdf: torch.Tensor
    discrete: torch.Tensor  # bool
    alive: torch.Tensor  # bool
    pick: torch.Tensor
    cluster: torch.Tensor
    n_shadow_rays: torch.Tensor
    n_path_rays: torch.Tensor
    packed: Optional[torch.Tensor] = None

    def columns(self) -> list:
        """The permute's float columns: the packed tensor, or the 12 fields
        as (N, k) tensors."""
        if self.packed is not None:
            return [self.packed]
        return [
            self.p, self.nee_wi, self.smaxt[:, None], self.pd, self.li, self.throughput,
            self.eta[:, None], self.accum[:, None], self.contrib, self.bsdf_pdf[:, None],
            self.discrete[:, None].to(torch.float32), self.alive[:, None].to(torch.float32),
        ]


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def supported_reason(arrays, static) -> Tuple[bool, str]:
    """(ok, reason): is the scene in the kernel's class? From the static
    description alone (no device read)."""
    if static.integrator_kind != "path_mis":
        return False, "integrator is not path_mis"
    if static.env_importance:
        return False, "env importance sampling enabled"
    if BSDF_NORMALMAP in static.btypes_present:
        return False, "normal map present"
    if any(t not in SUPPORTED_BTYPES for t in static.btypes_present):
        return False, "BSDF type outside the kernel's set"
    if static.textured_fields:
        return False, f"textured material field {', '.join(static.textured_fields)}"
    return True, "supported"


def _grad_tensors(arrays):
    mt = arrays.materials
    yield mt.base_color
    for name in MAT_FIELDS:
        yield getattr(mt, name)
    yield from (arrays.face_shade, arrays.light_radiance, arrays.light_inv_area,
                arrays.light_cdf)


def route_reason(arrays, static, tensors) -> Tuple[str, str]:
    """(route, reason) of one bounce: "kernel" for CUDA tensors of a scene in
    the kernel's class outside autograd, else "plain". ``tensors`` are the
    lane state the stage reads."""
    ok, reason = supported_reason(arrays, static)
    if not ok:
        return "plain", reason
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (*tensors, *_grad_tensors(arrays))
    ):
        return "plain", "autograd call"
    dev = tensors[0].device
    if dev.type != "cuda":
        return "plain", f"{dev.type.upper()} tensors"
    return "kernel", "supported"


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShadeTables:
    mats: torch.Tensor  # (M, 16)
    ltris: torch.Tensor  # (max(L, 1) * maxLF, 18)
    linfo: torch.Tensor  # (max(L, 1), 8)
    lcdf: torch.Tensor  # (max(L, 1), maxLF + 1)
    maxlf: int
    source: tuple  # ((tensor, its version) ...) the tables were packed from


def _sources(arrays) -> tuple:
    mt = arrays.materials
    return (mt.btype, *_grad_tensors(arrays), arrays.light_faces, arrays.light_mesh,
            arrays.mesh_has_normals)


def pack_tables(arrays) -> ShadeTables:
    """The kernel's material rows and light tables, on the scene's device
    (torch operations: no host read)."""
    mt = arrays.materials
    m = mt.btype.shape[0]
    dev = mt.btype.device
    f32 = torch.float32
    mats = torch.cat(
        [mt.btype.to(f32)[:, None], mt.base_color.detach().to(f32),
         *(getattr(mt, k).detach().to(f32)[:, None] for k in MAT_FIELDS),
         torch.zeros((m, MAT_F - 4 - len(MAT_FIELDS)), dtype=f32, device=dev)], 1)
    lf = arrays.light_faces
    nl, maxlf = lf.shape
    ltris = arrays.face_shade.detach()[lf.reshape(-1)][:, :LTRI_F].to(f32)
    has_n = arrays.mesh_has_normals[arrays.light_mesh].to(f32)
    linfo = torch.cat(
        [arrays.light_radiance.detach().to(f32), arrays.light_inv_area.detach().to(f32)[:, None],
         has_n[:, None], torch.zeros((nl, LINFO_F - 5), dtype=f32, device=dev)], 1)
    return ShadeTables(
        mats=mats.contiguous(), ltris=ltris.contiguous(), linfo=linfo.contiguous(),
        lcdf=arrays.light_cdf.detach().to(f32).contiguous(), maxlf=int(maxlf),
        source=tuple((t, t._version) for t in _sources(arrays)),
    )


def tables_for(arrays) -> ShadeTables:
    """The scene's packed tables, packed again where a source tensor was
    replaced (a swapped-in parameter) or changed in place since."""
    tb = getattr(arrays, "shade_tables", None)
    if tb is not None and all(
        t is s and t._version == v for (s, v), t in zip(tb.source, _sources(arrays))
    ):
        return tb
    return pack_tables(arrays)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def build_library() -> "tuple[str, str]":
    """Compile csrc/bounce.cu for sm_90a into the build directory (once per
    source hash). Returns (library path, compiler output)."""
    return cuda_build.build_library(SOURCE, "libkazen_shade", NVCC_FLAGS)


_P = ctypes.c_void_p
_LL = ctypes.c_longlong


class _Params(ctypes.Structure):
    _fields_ = [
        ("rows", _P), ("rows_s", _LL),
        ("ray_o", _P), ("o_sl", _LL), ("o_sc", _LL),
        ("ray_d", _P), ("d_sl", _LL), ("d_sc", _LL),
        ("li", _P), ("li_sl", _LL), ("li_sc", _LL),
        ("thr", _P), ("thr_sl", _LL), ("thr_sc", _LL),
        ("eta", _P), ("eta_s", _LL),
        ("bsdf_pdf", _P), ("pdf_s", _LL),
        ("accum", _P), ("acc_s", _LL),
        ("alive", _P), ("discrete", _P),
        ("u_rr", _P), ("u_pick", _P), ("u_tri", _P), ("u_a", _P), ("u_b", _P),
        ("s1", _P), ("s2", _P),
        ("mats", _P), ("ltris", _P), ("linfo", _P), ("lcdf", _P),
        ("out", _P), ("pick", _P), ("cluster", _P), ("counts", _P),
    ] + [(name, ctypes.c_int) for name in (
        "n", "L", "maxlf", "n_strat", "draw_rr", "regularization", "wi_order_b")
    ] + [("trace_bias", ctypes.c_float), ("acc_scale", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    lib.kz_shade_bounce.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    lib.kz_shade_bounce.restype = ctypes.c_int
    lib.kz_error_string.argtypes = [ctypes.c_int]
    lib.kz_error_string.restype = ctypes.c_char_p
    return lib


def _vec(name, t, n, dev):
    """(pointer, lane stride, component stride) of an (n, 3) f32 tensor."""
    if t.dtype != torch.float32 or tuple(t.shape) != (n, 3) or t.device != dev:
        raise ValueError(f"{name} must be float32 ({n}, 3) on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr(), t.stride(0), t.stride(1)


def _lane(name, t, n, dev, dtype=torch.float32):
    """(pointer, stride) of an (n,) tensor."""
    if t.dtype != dtype or tuple(t.shape) != (n,) or t.device != dev:
        raise ValueError(f"{name} must be {dtype} ({n},) on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr(), t.stride(0)


def _table(name, t, shape, dev):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"tables.{name} must be float32 {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"tables.{name} must be contiguous")
    return t.data_ptr()


def shade_cuda(tables: ShadeTables, static, rows, ray_o, ray_d, li, alive, throughput, eta,
               bsdf_pdf, discrete, accum, draws: Draws) -> ShadeOut:
    """The kernel on CUDA tensors: ``rows`` (40, N) from K1 (or a lane
    prefix of them, each row contiguous), the lane state
    after _shade_prologue (vectors may be strided views), the bounce's
    uniforms (Russian roulette where ``draws.u_rr`` is given) -> ShadeOut."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the shade kernel takes CUDA tensors, got {dev}")
    n = ray_o.shape[0]
    if n >= 2**31:
        raise ValueError("too many lanes for one launch")
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != n \
            or rows.shape[0] < 34 or rows.stride(1) != 1 or rows.device != dev:
        raise ValueError(f"rows must be float32 (40, {n}) on {dev}, each row contiguous")
    n_strat = static.num_lights
    nl = tables.linfo.shape[0]
    if n_strat > nl:
        raise ValueError("light tables smaller than the scene's lights")
    vo, vd = _vec("ray_o", ray_o, n, dev), _vec("ray_d", ray_d, n, dev)
    vli, vthr = _vec("li", li, n, dev), _vec("throughput", throughput, n, dev)
    sc_eta = _lane("eta", eta, n, dev)
    sc_pdf = _lane("bsdf_pdf", bsdf_pdf, n, dev)
    sc_acc = _lane("accum", accum, n, dev)
    alive = alive.contiguous()
    discrete = discrete.contiguous()
    _lane("alive", alive, n, dev, torch.bool)
    _lane("discrete", discrete, n, dev, torch.bool)

    def draw(name, t, shape):
        if t is None:
            return None
        t = t.contiguous()
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"draws.{name} must be float32 {shape} on {dev}")
        return t

    if n_strat > 0 and None in (draws.u_pick, draws.u_tri, draws.u_a, draws.u_b):
        raise ValueError("the draws lack the NEE uniforms the scene's lights consume")
    u = {k: draw(k, getattr(draws, k), (n,)) for k in ("u_rr", "u_pick", "u_tri", "u_a", "u_b",
                                                       "s1")}
    s2 = draw("s2", draws.s2, (n, 2))
    maxlf = tables.maxlf
    out = torch.empty((n, OUT_COLS), dtype=torch.float32, device=dev)
    pick = torch.empty(n, dtype=torch.int64, device=dev)
    cluster = torch.empty(n, dtype=torch.int64, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    ptr = {k: (t.data_ptr() if t is not None else None) for k, t in u.items()}
    prm = _Params(
        rows.data_ptr(), rows.stride(0), *vo, *vd, *vli, *vthr, *sc_eta, *sc_pdf, *sc_acc,
        alive.data_ptr(), discrete.data_ptr(),
        ptr["u_rr"], ptr["u_pick"], ptr["u_tri"], ptr["u_a"], ptr["u_b"], ptr["s1"],
        s2.data_ptr(),
        _table("mats", tables.mats, (tables.mats.shape[0], MAT_F), dev),
        _table("ltris", tables.ltris, (nl * maxlf, LTRI_F), dev),
        _table("linfo", tables.linfo, (nl, LINFO_F), dev),
        _table("lcdf", tables.lcdf, (nl, maxlf + 1), dev),
        out.data_ptr(), pick.data_ptr(), cluster.data_ptr(), counts.data_ptr(),
        n, static.num_lights, maxlf, n_strat, int(draws.u_rr is not None),
        int(static.regularization),
        # to_local(-ray_d)'s reduce order: PyTorch reduces the product over
        # its fastest dimension where ray_d's components are its fastest
        int(not ray_d.stride(1) < ray_d.stride(0)),
        static.trace_bias, static.accumulated_roughness,
    )
    if n > 0:
        lib = _library()
        with torch.cuda.device(dev):
            code = lib.kz_shade_bounce(ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
        SHADE.launches += 1
        if code != 0:
            raise RuntimeError(
                f"{SHADE.name} launch failed: {lib.kz_error_string(code).decode()} ({code})")
    rays = counts.to(torch.float32)
    return ShadeOut(
        p=out[:, 0:3], nee_wi=out[:, 3:6], smaxt=out[:, 6], pd=out[:, 7:10], li=out[:, 10:13],
        throughput=out[:, 13:16], eta=out[:, 16], accum=out[:, 17], contrib=out[:, 18:21],
        bsdf_pdf=out[:, 21], discrete=out[:, 22] > 0.5, alive=out[:, 23] > 0.5,
        pick=pick, cluster=cluster, n_shadow_rays=rays[0], n_path_rays=rays[1], packed=out,
    )
