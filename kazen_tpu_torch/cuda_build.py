"""Building the port's CUDA sources and counting their launches.

Each ``*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ctypes. The library is
named by a hash of the source and the flags and lives in the build
directory, so a source is compiled once per change. Every kernel wrapper
keeps a ``CudaKernel`` whose ``launches`` it raises by one each time it
launches its kernel; ``KERNELS`` lists them all (``utils.metrics.collect``
reads their counts).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Sequence, Tuple

from .build_dir import build_dir
from .utils import metrics

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
KERNELS = []  # every CudaKernel made


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_library(source: str, stem: str, flags: Sequence[str] = ()) -> Tuple[str, str]:
    """Compile ``source`` with ``flags`` into ``<build dir>/<stem>_<hash>.so``
    unless it is there already. Returns (library path, compiler output; empty
    when nothing was compiled). ``-Xptxas -v`` is always on, so the output
    holds each kernel's registers and spills."""
    cmd = [
        *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", *flags,
    ]
    with open(source, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(cmd).encode()).hexdigest()[:12]
    lib = os.path.join(build_dir(), f"{stem}_{tag}.so")
    if os.path.exists(lib):
        return lib, ""
    tmp = f"{lib}.{os.getpid()}.tmp"
    with metrics.span("cuda_build", "stem", stem):
        res = subprocess.run(
            [nvcc(), *cmd, "-o", tmp, source], capture_output=True, text=True
        )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


class CudaKernel:
    """One kernel entry point and its launch count: the wrapper adds one
    each time it launches the kernel, and nowhere else."""

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.launches = 0
        KERNELS.append(self)
