"""The shade kernel's source (shade/csrc/bounce.cu) built for the host with
g++ and put in the CUDA library's place, so that path_mis._shade's kernel
route runs on CPU lanes: the tests hold its body against the plain version
and drive the benchmark's capture of its launches without a card."""
import contextlib
import ctypes
import shutil
import subprocess
from types import SimpleNamespace

import pytest
import torch

from kazen_tpu_torch.shade import bounce_kernel as bk

LAUNCHES_BANNER = "// " + "-" * 75 + "\n// the launches (nvcc only)"
# the CUDA names bounce.cu uses, for one host thread (a warp of one lane),
# in place of the CUDA runtime's header
HOST_SHIM = r"""
#pragma once
#include <cmath>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  const unsigned long long old = *a;
  *a += v;
  return old;
}
using std::isfinite;
using std::isnan;
static struct { unsigned x; } blockIdx, threadIdx;
"""
# the library's entry point: the kernel body once a lane, in order
HOST_DRIVER = r"""
#include "bounce_body.cu"
namespace {
template <bool TEX, bool NMAP, bool ROUGH, bool ENV> void run(const Params& p) {
  for (long long i = 0; i < p.n; ++i) {
    blockIdx.x = (unsigned)(i / THREADS);
    threadIdx.x = (unsigned)(i % THREADS);
    shade_kernel<TEX, NMAP, ROUGH, ENV>(p);
  }
}
}  // namespace
extern "C" int kz_shade_bounce(const Params* p, void*) {
  const bool tex = p->tex_fields != 0, nmap = p->nmap != 0;
  if (p->rough || p->env) run<true, true, true, true>(*p);
  else if (tex && nmap) run<true, true, false, false>(*p);
  else if (tex) run<true, false, false, false>(*p);
  else if (nmap) run<false, true, false, false>(*p);
  else run<false, false, false, false>(*p);
  return 0;
}
extern "C" const char* kz_error_string(int) { return "host failure"; }
"""


def build(d):
    """bounce.cu above its launches' banner, built for the host with g++ in
    the directory ``d`` (no contraction of products and sums, as
    -fmad=false on the card); skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    with open(bk.SOURCE) as f:
        source = f.read()
    (d / "cuda_runtime.h").write_text(HOST_SHIM)
    (d / "bounce_body.cu").write_text(source[:source.index(LAUNCHES_BANNER)])
    (d / "driver.cpp").write_text(HOST_DRIVER)
    lib = d / "libshade_host.so"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-I", str(d),
         "-o", str(lib), str(d / "driver.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    cdll = ctypes.CDLL(str(lib))
    cdll.kz_shade_bounce.argtypes = [ctypes.POINTER(bk._Params), ctypes.c_void_p]
    cdll.kz_shade_bounce.restype = ctypes.c_int
    cdll.kz_error_string.argtypes = [ctypes.c_int]
    cdll.kz_error_string.restype = ctypes.c_char_p
    return cdll


def kernel_on_host(monkeypatch, lib):
    """The host build in the CUDA library's place, and path_mis._shade's
    kernel route for CPU lanes of a scene in the kernel's class."""
    monkeypatch.setattr(bk, "_library", lambda: lib)
    monkeypatch.setattr(bk, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))

    def kernel_route(arrays, static, tensors):
        ok, reason = bk.supported_reason(arrays, static)
        return ("kernel", reason) if ok else ("plain", reason)

    monkeypatch.setattr(bk, "route_reason", kernel_route)
