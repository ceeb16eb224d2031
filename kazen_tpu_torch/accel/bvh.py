"""Host-side binned-SAH BVH build (the build half of kazen_tpu/accel/bvh.py).

Recursive binned SAH (16 bins over the centroid extent's widest axis),
flattened in DFS order with escape links: ``skip[i]`` is the node to visit
when node i's box is missed or after a leaf. The native C++ builder
(accel/native) and the numpy recursion give the same layout; which one ran
is logged and recorded in ``BVH.builder``, because the cluster ids of the
trace tables follow the tree.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from . import native

LOG = logging.getLogger(__name__)
LEAF_SIZE = 4
_SAH_BINS = 16


@dataclass
class BVH:
    bounds_min: np.ndarray  # (M, 3) f32
    bounds_max: np.ndarray  # (M, 3) f32
    skip: np.ndarray  # (M,) i32: next node on miss / after a leaf
    prim_offset: np.ndarray  # (M,) i32 into prim_faces (leaves)
    prim_count: np.ndarray  # (M,) i32, 0 for internal nodes
    prim_faces: np.ndarray  # (F,) i32 global face ids, leaf-contiguous
    builder: str  # "native" or "numpy"


def build_bvh(
    V: np.ndarray, F: np.ndarray, leaf_size: int = LEAF_SIZE, backend: str = "auto"
) -> BVH:
    """backend: 'auto' takes the native builder when it builds, else numpy;
    'numpy'/'native' force one."""
    V = np.asarray(V, np.float32)
    F = np.asarray(F, np.int32)
    if len(F) == 0:
        raise ValueError("empty scene")
    if backend in ("auto", "native"):
        res = native.build(V, F, leaf_size)
        if res is not None:
            LOG.info("BVH built by the native builder (%d faces)", len(F))
            return BVH(*res, builder="native")
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable")
    LOG.info("BVH built by the numpy builder (%d faces)", len(F))
    return _build_numpy(V, F, leaf_size)


def _build_numpy(V: np.ndarray, F: np.ndarray, leaf_size: int) -> BVH:
    p0 = V[F[:, 0]]
    p1 = V[F[:, 1]]
    p2 = V[F[:, 2]]
    fmin = np.minimum(np.minimum(p0, p1), p2)
    fmax = np.maximum(np.maximum(p0, p1), p2)
    centroid = (fmin + fmax) * 0.5

    bounds_min, bounds_max, skip, prim_offset, prim_count = [], [], [], [], []
    prim_faces = []

    def area(mn, mx):
        return float(
            2
            * (
                (mx[0] - mn[0]) * (mx[1] - mn[1])
                + (mx[1] - mn[1]) * (mx[2] - mn[2])
                + (mx[0] - mn[0]) * (mx[2] - mn[2])
            )
        )

    def emit(face_ids) -> None:
        node = len(bounds_min)
        bounds_min.append(fmin[face_ids].min(axis=0))
        bounds_max.append(fmax[face_ids].max(axis=0))
        skip.append(-1)  # patched after the subtree is emitted
        if len(face_ids) <= leaf_size:
            prim_offset.append(len(prim_faces))
            prim_count.append(len(face_ids))
            prim_faces.extend(face_ids.tolist())
        else:
            prim_offset.append(0)
            prim_count.append(0)
            c = centroid[face_ids]
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            left_ids = right_ids = None
            if ext[axis] > 1e-12:
                lo = c[:, axis].min()
                scale = _SAH_BINS * (1.0 - 1e-6) / ext[axis]
                bins = np.minimum(
                    ((c[:, axis] - lo) * scale).astype(np.int32), _SAH_BINS - 1
                )
                best_cost = np.inf
                best_split = -1
                for split in range(1, _SAH_BINS):
                    lmask = bins < split
                    nl = int(lmask.sum())
                    nr = len(face_ids) - nl
                    if nl == 0 or nr == 0:
                        continue
                    cost = nl * area(
                        fmin[face_ids[lmask]].min(axis=0),
                        fmax[face_ids[lmask]].max(axis=0),
                    ) + nr * area(
                        fmin[face_ids[~lmask]].min(axis=0),
                        fmax[face_ids[~lmask]].max(axis=0),
                    )
                    if cost < best_cost:
                        best_cost = cost
                        best_split = split
                if best_split > 0:
                    lmask = bins < best_split
                    left_ids = face_ids[lmask]
                    right_ids = face_ids[~lmask]
            if left_ids is None:
                # degenerate centroids: median split
                order = np.argsort(c[:, axis], kind="stable")
                half = len(order) // 2
                left_ids = face_ids[order[:half]]
                right_ids = face_ids[order[half:]]
            emit(left_ids)
            emit(right_ids)
        skip[node] = len(bounds_min)

    emit(np.arange(len(F), dtype=np.int32))
    return BVH(
        bounds_min=np.asarray(bounds_min, np.float32),
        bounds_max=np.asarray(bounds_max, np.float32),
        skip=np.asarray(skip, np.int32),
        prim_offset=np.asarray(prim_offset, np.int32),
        prim_count=np.asarray(prim_count, np.int32),
        prim_faces=np.asarray(prim_faces, np.int32),
        builder="numpy",
    )
