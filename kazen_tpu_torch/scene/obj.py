"""Wavefront OBJ loader (numpy), matching the reference's hand-rolled parser
(mesh.cpp:200-343): v/vt/vn/f records, triangles + quads (split 0-1-2 /
0-2-3), per-file ``to_world`` applied at load (points by M, normals by
inverse-transpose, normalized), vertex dedup on (p, uv, n) index triples.

The port of ``kazen_tpu/scene/obj.py``, step for step, so both packages
load a file to the same float32 bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_obj(
    path: str, to_world: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Returns (vertices (V,3), faces (F,3) int32, normals (V,3) or None,
    uvs (V,2) or None)."""
    positions = []
    texcoords = []
    normals = []
    tri_verts = []  # list of (p_idx, uv_idx, n_idx), 1-based, 0 = absent

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                texcoords.append([float(parts[1]), float(parts[2])])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "f":
                verts = []
                for tok in parts[1:5]:
                    comps = tok.split("/")
                    p = int(comps[0]) if comps[0] else 0
                    uv = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    n = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    verts.append((p, uv, n))
                tri_verts.append((verts[0], verts[1], verts[2]))
                if len(parts) == 5:  # quad -> second triangle (mesh.cpp:266-271)
                    tri_verts.append((verts[3], verts[0], verts[2]))

    positions = np.asarray(positions, np.float32)
    texcoords = np.asarray(texcoords, np.float32) if texcoords else None
    normals_arr = np.asarray(normals, np.float32) if normals else None

    if to_world is not None:
        m = np.asarray(to_world, np.float32)
        positions = positions @ m[:3, :3].T + m[:3, 3]
        if normals_arr is not None:
            nmat = np.linalg.inv(m[:3, :3]).T
            normals_arr = normals_arr @ nmat.T
            normals_arr /= np.maximum(
                np.linalg.norm(normals_arr, axis=-1, keepdims=True), 1e-9
            )

    # Dedup identical (p, uv, n) triples into shared vertices.
    vert_map = {}
    out_pos = []
    out_uv = []
    out_n = []
    faces = []
    has_uv = texcoords is not None
    has_n = normals_arr is not None
    for tri in tri_verts:
        idxs = []
        for key in tri:
            if key not in vert_map:
                vert_map[key] = len(out_pos)
                p, uv, n = key
                out_pos.append(positions[p - 1])
                if has_uv:
                    out_uv.append(
                        texcoords[uv - 1] if uv > 0 else np.zeros(2, np.float32)
                    )
                if has_n:
                    out_n.append(
                        normals_arr[n - 1] if n > 0 else np.zeros(3, np.float32)
                    )
            idxs.append(vert_map[key])
        faces.append(idxs)

    V = np.asarray(out_pos, np.float32)
    F = np.asarray(faces, np.int32)
    N = np.asarray(out_n, np.float32) if has_n else None
    UV = np.asarray(out_uv, np.float32) if has_uv else None
    return V, F, N, UV
