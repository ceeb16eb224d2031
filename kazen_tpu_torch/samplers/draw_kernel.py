"""The sampler's draws in one CUDA launch each (``csrc/draws.cu``).

``samplers/streams.py``'s four draw functions route by what their lanes
show: CUDA tensors launch the kernel here (or raise), CPU tensors take the
plain version beside them. The wrappers take the stream's fields as they
are, strided views included (the ordered permute hands them on as columns
of one (N, 7) tensor), pass every static value (the seed, the sample count,
the strata, the pixel tile, a jump and sample index that are one for all
lanes) as a kernel argument, so a draw makes no host read and no copy onto
the card, and allocate the fields the draw changes and its uniforms with
``torch.empty``. They return raw tensors; streams.py builds the
``StreamState``.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from .. import cuda_build
from ..cuda_build import CudaKernel

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "draws.cu")
# every product and sum rounds on its own, as the plain version's ops do
NVCC_FLAGS = ("-fmad=false",)
KIND_IDS = {"independent": 0, "stratified": 1, "correlated": 2, "pmj02bn": 3}
INIT, NEXT_1D, NEXT_2D, PIXEL_2D = range(4)
PMJ_SHAPE = (5, 65536, 2)
BLUENOISE_SHAPE = (48, 128, 128)
_MASK64 = (1 << 64) - 1

# replaces no TPU kernel: kazen_tpu's draws are XLA-fused elementwise code
DRAWS = CudaKernel("sampler_draw",
                   "none (kazen_tpu/samplers/streams.py, kazen_tpu/core/rng.py, XLA-fused)")


def build_library() -> "tuple[str, str]":
    """Compile csrc/draws.cu for sm_90a into the build directory (once per
    source hash). Returns (library path, compiler output)."""
    return cuda_build.build_library(SOURCE, "libkazen_sampler", NVCC_FLAGS)


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong


class _Params(ctypes.Structure):
    _fields_ = [
        ("state", _P), ("state_s", _LL), ("inc", _P), ("inc_s", _LL),
        ("dim", _P), ("dim_s", _LL), ("px", _P), ("px_s", _LL), ("py", _P), ("py_s", _LL),
        ("sample_index", _P), ("sample_index_s", _LL),
        ("jump_a", _P), ("jump_a_s", _LL), ("jump_s", _P), ("jump_s_s", _LL),
        ("si0", _LL), ("ja0", _ULL), ("js0", _ULL), ("seed", _ULL),
        ("state_out", _P), ("inc_out", _P), ("dim_out", _P), ("si_out", _P), ("u", _P),
        ("pmj", _P), ("bluenoise", _P), ("tile", _P),
        ("lanes", _LL), ("tile_entries", _LL),
    ] + [(name, ctypes.c_int) for name in ("op", "kind", "n", "res_x", "res_y", "tile_size")]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    lib.kz_sampler_draw.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    lib.kz_sampler_draw.restype = ctypes.c_int
    lib.kz_error_string.argtypes = [ctypes.c_int]
    lib.kz_error_string.restype = ctypes.c_char_p
    return lib


def _lane(name, t, n, dev):
    """(pointer, lane stride) of an int64 (n,) lane tensor on ``dev``; any
    stride (the permute's columns are strided views)."""
    if t.dtype != torch.int64 or tuple(t.shape) != (n,) or t.device != dev:
        raise ValueError(f"{name} must be an int64 ({n},) lane tensor on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr(), t.stride(0)


def _table(name, t, shape, dev):
    if t is None:
        raise ValueError(f"the pmj02bn spec lacks its {name} table")
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{name} must be float32 {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _empty(n, dtype, dev, width=1):
    return torch.empty((n,) if width == 1 else (n, width), dtype=dtype, device=dev)


def _params(spec, op, fields, dev, n) -> _Params:
    """The launch's parameters from ``spec`` and the lane fields in
    ``fields`` ({name: tensor}), each checked."""
    if n >= 2**31:
        raise ValueError("too many lanes for one launch")
    count = spec.effective_sample_count
    if not 1 <= count < 2**31:
        raise ValueError(f"sample count {count} outside the kernel's range")
    prm = _Params(op=op, kind=KIND_IDS[spec.kind], n=count, lanes=n,
                  seed=spec.seed & _MASK64)
    for name, t in fields.items():
        ptr, stride = _lane(name, t, n, dev)
        setattr(prm, name, ptr)
        setattr(prm, f"{name}_s", stride)
    if spec.kind in ("stratified", "correlated"):
        prm.res_x, prm.res_y = spec.resolution
    if spec.kind == "pmj02bn" and op != INIT:
        prm.pmj = _table("pmj_tables", spec.pmj_tables, PMJ_SHAPE, dev)
        prm.bluenoise = _table("bluenoise", spec.bluenoise, BLUENOISE_SHAPE, dev)
        if spec.pmj_pixel_table is None:
            raise ValueError("the pmj02bn spec lacks its pixel-tile table")
        tile, prm.tile_size = spec.pmj_pixel_table
        prm.tile = _table("pixel tile", tile, (tile.shape[0], 2), dev)
        prm.tile_entries = tile.shape[0]
    return prm


def _launch(prm: _Params, dev) -> None:
    """One launch on ``dev``'s current stream (none for no lanes); raises
    if the launch failed."""
    if prm.lanes == 0:
        return
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.kz_sampler_draw(ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    DRAWS.launches += 1
    if code != 0:
        raise RuntimeError(
            f"{DRAWS.name} launch failed: {lib.kz_error_string(code).decode()} ({code})")


def init(spec, px, py, sample_index, jump):
    """init_stream_jump on the card: int64 lanes ``px``, ``py``; the sample
    index and the jump (A, S) one for all lanes (an int, two ints) or one a
    lane (int64 lane tensors). Returns (state, inc, dim, sample_index)."""
    dev, n = px.device, px.shape[0]
    fields = {"px": px, "py": py}
    per_lane_si = isinstance(sample_index, torch.Tensor)
    if per_lane_si:
        fields["sample_index"] = sample_index
    a, s = jump
    if isinstance(a, torch.Tensor) != isinstance(s, torch.Tensor):
        raise ValueError("the jump's A and S must both be ints or both lane tensors")
    if isinstance(a, torch.Tensor) and spec.kind != "pmj02bn":  # pmj02bn takes no jump
        fields["jump_a"], fields["jump_s"] = a, s
    prm = _params(spec, INIT, fields, dev, n)
    if not isinstance(a, torch.Tensor):
        prm.ja0, prm.js0 = a & _MASK64, s & _MASK64
    state, inc, dim = (_empty(n, torch.int64, dev) for _ in range(3))
    prm.state_out, prm.inc_out, prm.dim_out = state.data_ptr(), inc.data_ptr(), dim.data_ptr()
    if per_lane_si:
        si = sample_index
    else:
        si = _empty(n, torch.int64, dev)
        prm.si0, prm.si_out = int(sample_index), si.data_ptr()
    _launch(prm, dev)
    return state, inc, dim, si


def draw(spec, st, width: int):
    """next_1d (``width`` 1) or next_2d (2) on the card. Returns (state,
    dim, u): a field the kind does not change is the stream's own tensor."""
    dev, n = st.px.device, st.px.shape[0]
    op = NEXT_1D if width == 1 else NEXT_2D
    pcg = spec.kind != "pmj02bn"
    fields = {"state": st.state, "inc": st.inc} if pcg else {}
    if spec.kind != "independent":
        fields.update(dim=st.dim, px=st.px, py=st.py, sample_index=st.sample_index)
    prm = _params(spec, op, fields, dev, n)
    state = _empty(n, torch.int64, dev) if pcg else st.state
    dim = _empty(n, torch.int64, dev) if spec.kind != "independent" else st.dim
    u = _empty(n, torch.float32, dev, width)
    if pcg:
        prm.state_out = state.data_ptr()
    if spec.kind != "independent":
        prm.dim_out = dim.data_ptr()
    prm.u = u.data_ptr()
    _launch(prm, dev)
    return state, dim, u


def pixel_2d(spec, st):
    """pmj02bn's next_pixel_2d on the card: the (N, 2) pixel-tile uniforms."""
    dev, n = st.px.device, st.px.shape[0]
    if spec.kind != "pmj02bn":
        raise ValueError("only pmj02bn has a pixel draw of its own")
    prm = _params(spec, PIXEL_2D, {"px": st.px, "py": st.py, "sample_index": st.sample_index},
                  dev, n)
    u = _empty(n, torch.float32, dev, 2)
    prm.u = u.data_ptr()
    _launch(prm, dev)
    return u
