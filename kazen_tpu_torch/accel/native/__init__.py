"""ctypes loader for the native binned-SAH BVH builder (``bvh_builder.cpp``,
the same source as kazen_tpu's). Compiled with ``g++`` at first use into the
package's build directory, under a name keyed by the source's hash. Returns
None when no compiler is available; ``accel/bvh.py`` then runs its numpy
builder and logs which builder ran."""
from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from ...build_dir import build_dir

LOG = logging.getLogger(__name__)
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bvh_builder.cpp")


def library_path() -> str:
    """Build (once) and return the path of the shared library."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    lib = os.path.join(build_dir(), f"libbvh_{tag}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(library_path())
    except (OSError, subprocess.CalledProcessError) as e:
        LOG.warning("native BVH builder unavailable (%s)", e)
        return None
    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.bvh_read.restype = None
    lib.bvh_read.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)
    ] * 2 + [ctypes.POINTER(ctypes.c_int32)] * 4
    lib.bvh_free.restype = None
    lib.bvh_free.argtypes = [ctypes.c_void_p]
    return lib


def build(
    V: np.ndarray, F: np.ndarray, leaf_size: int
) -> Optional[Tuple[np.ndarray, ...]]:
    """(bounds_min, bounds_max, skip, prim_offset, prim_count, prim_faces),
    or None when the native builder is unavailable."""
    lib = _load()
    if lib is None:
        return None
    V = np.ascontiguousarray(V, np.float32)
    F = np.ascontiguousarray(F, np.int32)
    nf = len(F)
    n_nodes = ctypes.c_int32(0)
    handle = lib.bvh_build(
        V.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(V),
        F.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nf,
        leaf_size,
        ctypes.byref(n_nodes),
    )
    m = n_nodes.value
    out = (
        np.empty((m, 3), np.float32),
        np.empty((m, 3), np.float32),
        np.empty(m, np.int32),
        np.empty(m, np.int32),
        np.empty(m, np.int32),
        np.empty(nf, np.int32),
    )
    try:
        lib.bvh_read(
            handle,
            *(a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in out[:2]),
            *(a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for a in out[2:]),
        )
    finally:
        lib.bvh_free(handle)
    return out
