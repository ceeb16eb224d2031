"""The lab probes K4-K6: the ports of ``benchmarks/mxu_lab.py`` and
``benchmarks/visit_lab.py``, the cost probes of the cluster-trace kernel's
pieces. They are not on a path of ``render()``.

* ``mxu_lab``: K4, the repeated matrix product (``mm_probe``), and K5, the
  Moller-Trumbore acceptance chain (``chain_probe``);
* ``visit_lab``: K6, the simulated leaf visits (``make_drain``).

The three kernels live in one source, ``csrc/lab.cu``, built by
``cuda_build.build_library`` into one ctypes library. Each wrapper launches
its kernel for CUDA tensors and takes its plain PyTorch version for CPU
tensors. ``python -m kazen_tpu_torch.lab.mxu_lab`` and
``python -m kazen_tpu_torch.lab.visit_lab`` run the probes' tables.
"""
from __future__ import annotations

import ctypes
import functools
import os
import time

import torch

from .. import cuda_build
from ..cuda_build import CudaKernel

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "lab.cu")


def build_library() -> "tuple[str, str]":
    """Compile csrc/lab.cu for sm_90a into the build directory (once per
    source hash). Returns (library path, compiler output)."""
    return cuda_build.build_library(SOURCE, "libkazen_lab")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kz_mm_probe.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.kz_mm_probe.restype = i
    lib.kz_chain_probe.argtypes = [p, p, p, p, i, i, p]
    lib.kz_chain_probe.restype = i
    lib.kz_drain_probe.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.kz_drain_probe.restype = i
    lib.kz_error_string.argtypes = [i]
    lib.kz_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(code: int, kernel: CudaKernel) -> None:
    if code != 0:
        msg = library().kz_error_string(code).decode()
        raise RuntimeError(f"{kernel.name} launch failed: {msg} ({code})")


def timed(fn, device: torch.device, calls: int) -> float:
    """ms per call of ``fn`` over ``calls`` calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3 / calls


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
