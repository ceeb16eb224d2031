"""Cluster-BVH ray tracing: nearest hit (``trace``) and any hit (``occluded``).

The port of ``kazen_tpu/accel/cluster_trace.py``. Triangles are grouped into
clusters of up to K = 128 (the same SAH BVH and the same greedy collapse as
the reference, so face and cluster ids are identical); the collapsed cluster
tree is stored as 8 per-direction-octant near-child-first preorders with
escape links (``node_scalars``).

Each query has three implementations with one contract:

* the CUDA kernels in ``csrc/cluster_trace.cu`` (one thread per ray walking
  the node table of its octant, the warp draining the leaves its lanes
  reach; Möller-Trumbore on each visited cluster's triangles in f32),
  launched for tensors on a CUDA device;
* plain PyTorch versions (a brute-force pass over clusters, the port of the
  reference's ``_run_shim``), used for tensors on the CPU and as the
  kernels' reference on the card;
* plain walks (``trace_walk_plain``, ``occluded_walk_plain``): the kernels'
  walk over the octant node tables written as a masked PyTorch loop, with
  the kernels' diagnostic rows. They hold the walk and the escape links to
  the brute force and to the JAX package on the CPU, and the kernels to
  their walk on the card; ``render()`` never calls them.

``trace`` returns the 40-row matrix the shade prep decodes
(shade/interaction.py:prepare_from_rows):

    0 t, 1 u, 2 v, 3 face, 4:28 shade24 [p0 p1 p2 n0 n1 n2 uv0 uv1 uv2],
    28 light, 29 lpv, 30 material, 31 has_n, 32 has_uv, 33 winner cluster,
    34 visits, 35 node steps, 36 triangle tests (diagnostics of the kernel
    and the plain walk; 0 in the brute-force version), 37:40 zero.

``occluded`` ignores faces of primary-invisible lights (they never block),
the single-pass analog of the reference's step-through re-casts
(integrator.cpp:259-278).
"""
from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import cuda_build
from ..cuda_build import CudaKernel
from ..utils import metrics
from .bvh import build_bvh
from .intersect import moller_trumbore, moller_trumbore_edges

K = 128  # triangles per cluster (BVH leaf size)
SH_ROWS = 32  # shade attribute rows per cluster
OUT_ROWS = 40
ANY_ROWS = 8  # any-hit output rows: 0 blocked, 1 visits, 2 steps, 3 tests
# the rows of OUT_ROWS that the nearest hit's nofetch instance writes (t,
# face, winner cluster, visits, node steps, triangle tests)
NOFETCH_ROWS = (0, 3, 33, 34, 35, 36)
TRI_F = 12  # per-triangle record [p0 | e1 | e2 | blocks, 0, 0]
NODE_F = 16  # per-node record [bmin3 bmax3 skip count cluster 0...]
BIG = 3.0e38
N_ORDERS = 8  # one node table per ray-direction octant

# geo_shade rows 24:30 (rows 0:24 are shade24)
_S_FACE = 24
_S_LIGHT = 25
_S_LPV = 26
_S_MAT = 27
_S_HASN = 28
_S_HASUV = 29
# Rows set to 1.0 in the miss sentinel: p1.x, p2.y and the vertex-normal z
# components -- a benign unit triangle, so the shade prep stays finite on
# missed lanes.
_MISS_ONE_ROWS = (3, 7, 11, 14, 17)

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(_CSRC, "cluster_trace.cu")


@dataclass
class ClusterTables:
    node_scalars: torch.Tensor  # (8, M, 16) f32 node records
    geo_shade: torch.Tensor  # (C, 32, K) f32 winner shading attributes
    leaf_bounds: torch.Tensor  # (Cpad, 6) f32 cluster AABBs [min3 max3]
    tri: torch.Tensor  # (C, K, 12) f32 triangle records for the kernels
    builder: str  # which BVH builder made the tree ("native" / "numpy")

    @property
    def num_clusters(self) -> int:
        return self.geo_shade.shape[0]

    def to(self, device) -> "ClusterTables":
        return ClusterTables(
            node_scalars=self.node_scalars.to(device),
            geo_shade=self.geo_shade.to(device),
            leaf_bounds=self.leaf_bounds.to(device),
            tri=self.tri.to(device),
            builder=self.builder,
        )


def triangle_records(geo_shade: np.ndarray) -> np.ndarray:
    """(C, 32, K) shade rows -> (C, K, 12) kernel records [p0, e1, e2,
    blocks, 0, 0]. The edges are the same f32 differences the plain version
    and the JAX shim form, so all three test identical triangles. ``blocks``
    is 0 for faces of primary-invisible lights and for padding."""
    gs = np.asarray(geo_shade, np.float32)
    p0 = gs[:, 0:3]
    rec = np.zeros((gs.shape[0], K, TRI_F), np.float32)
    rec[:, :, 0:3] = p0.transpose(0, 2, 1)
    rec[:, :, 3:6] = (gs[:, 3:6] - p0).transpose(0, 2, 1)
    rec[:, :, 6:9] = (gs[:, 6:9] - p0).transpose(0, 2, 1)
    real = gs[:, _S_FACE] >= 0.0
    inv_light = (gs[:, _S_LIGHT] >= 0.0) & (gs[:, _S_LPV] == 0.0)
    rec[:, :, 9] = np.where(real & ~inv_light, 1.0, 0.0)
    return rec


def octant_orders(node_scalars) -> np.ndarray:
    """(8, M, 16) node records from a packed node table. Rows past the root's
    escape link (padding no walk reaches) are dropped, and a table holding a
    single order serves all 8 octants: any preorder with escape links is a
    correct walk, only the near-child-first visiting order is lost."""
    nsc = np.asarray(node_scalars, np.float32)
    nsc = nsc[:, : int(nsc[0, 0, 6])]
    return np.ascontiguousarray(np.broadcast_to(nsc, (N_ORDERS,) + nsc.shape[1:]))


def tables_from_numpy(node_scalars, geo_shade, leaf_bounds, builder, device):
    """ClusterTables on ``device`` from the packed numpy arrays."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return ClusterTables(
        node_scalars=t(octant_orders(node_scalars)),
        geo_shade=t(geo_shade),
        leaf_bounds=t(leaf_bounds),
        tri=t(triangle_records(geo_shade)),
        builder=builder,
    )


def pack_cluster_tables(
    V,
    F,
    face_shade,  # (Nf, 24) f32 [p0 p1 p2 n0 n1 n2 uv0 uv1 uv2]
    face_light,  # (Nf,) light id per face, -1 none
    face_lpv,  # (Nf,) 0/1 light primary visibility per face
    face_material,  # (Nf,) material id per face
    face_has_n,  # (Nf,) 0/1
    face_has_uv,  # (Nf,) 0/1
    device,
) -> ClusterTables:
    """Host-side (numpy) packing of the two-level tables, following
    kazen_tpu's ``pack_cluster_tables`` step for step."""
    V = np.asarray(V, np.float32)
    F = np.asarray(F, np.int32)
    if len(F) >= (1 << 24):
        raise ValueError("face ids beyond f32-exact range")
    bvh = build_bvh(V, F, leaf_size=K)
    pcnt, poff, pfaces, nskip = (
        bvh.prim_count, bvh.prim_offset, bvh.prim_faces, bvh.skip
    )
    mn_all = len(pcnt)

    # ---- collapse: the shallowest subtree holding <= K faces is a cluster
    pref = np.concatenate([[0], np.cumsum(pcnt)])

    def faces_in(i):
        j = int(nskip[i])
        segs = [
            pfaces[poff[l]: poff[l] + pcnt[l]] for l in range(i, j) if pcnt[l] > 0
        ]
        return np.concatenate(segs) if segs else np.zeros(0, np.int32)

    cluster_root = []
    i = 0
    while i < mn_all:
        j = int(nskip[i])
        nprims = int(pref[j] - pref[i])
        if 0 < nprims <= K:
            cluster_root.append(i)
            i = j
        else:
            i += 1
    leaf_nodes = np.asarray(cluster_root, np.int64)
    C = len(leaf_nodes)

    # ---- per-cluster shading attributes
    geo_shade = np.zeros((C, SH_ROWS, K), np.float32)
    geo_shade[:, _S_FACE, :] = -1.0
    geo_shade[:, _S_LIGHT, :] = -1.0
    fs = np.asarray(face_shade, np.float32)
    meta = [
        (_S_LIGHT, face_light), (_S_LPV, face_lpv), (_S_MAT, face_material),
        (_S_HASN, face_has_n), (_S_HASUV, face_has_uv),
    ]
    cluster_sizes = np.zeros(C, np.int64)
    for ci, nidx in enumerate(leaf_nodes):
        fidx = faces_in(int(nidx))
        c = len(fidx)
        cluster_sizes[ci] = c
        geo_shade[ci, 0:24, :c] = fs[fidx].T
        geo_shade[ci, _S_FACE, :c] = fidx.astype(np.float32)
        for row, vals in meta:
            geo_shade[ci, row, :c] = np.asarray(vals, np.float32)[fidx]

    # ---- the collapsed tree (cluster roots + the internal nodes above)
    is_croot = np.zeros(mn_all, bool)
    is_croot[leaf_nodes] = True
    bmin_all = bvh.bounds_min
    bmax_all = bvh.bounds_max
    croot_cluster = np.full(mn_all, -1, np.int64)
    croot_cluster[leaf_nodes] = np.arange(C)

    cid_of = np.full(mn_all, -1, np.int64)
    corig, cleft, cright = [], [], []
    stack = [0]
    while stack:
        i = stack.pop()
        cid_of[i] = len(corig)
        corig.append(i)
        cleft.append(-1)
        cright.append(-1)
        if not is_croot[i]:
            a = i + 1
            b = int(nskip[a])
            me = cid_of[i]
            stack.append(b)
            stack.append(a)
            cleft[me] = a
            cright[me] = b
    M = len(corig)
    corig = np.asarray(corig)
    cleft = np.asarray(cleft)
    cright = np.asarray(cright)
    csize = np.ones(M, np.int64)
    for m in range(M - 1, -1, -1):  # children follow parents in preorder
        if cleft[m] >= 0:
            csize[m] += csize[cid_of[cleft[m]]] + csize[cid_of[cright[m]]]
    ccenter = (bmin_all[corig] + bmax_all[corig]) * 0.5

    nsc = np.zeros((N_ORDERS, M, NODE_F), np.float32)
    for o in range(N_ORDERS):
        sgn = (1.0 if o & 4 else -1.0, 1.0 if o & 2 else -1.0,
               1.0 if o & 1 else -1.0)
        # preorder DFS, near child first along this octant's direction signs
        emit = np.empty(M, np.int64)
        pos = 0
        stack = [0]
        while stack:
            m = stack.pop()
            emit[pos] = m
            pos += 1
            if cleft[m] >= 0:
                a = cid_of[cleft[m]]
                b = cid_of[cright[m]]
                sep = ccenter[a] - ccenter[b]
                ax = int(np.argmax(np.abs(sep)))
                near_is_a = (sep[ax] * sgn[ax]) < 0.0
                first, second = (a, b) if near_is_a else (b, a)
                stack.append(second)
                stack.append(first)
        eo = corig[emit]
        nsc[o, :, 0:3] = bmin_all[eo]
        nsc[o, :, 3:6] = bmax_all[eo]
        nsc[o, :, 6] = (np.arange(M) + csize[emit]).astype(np.float32)
        nsc[o, :, 7] = np.where(
            is_croot[eo], cluster_sizes[croot_cluster[eo]], 0
        ).astype(np.float32)
        nsc[o, :, 8] = np.maximum(croot_cluster[eo], 0).astype(np.float32)

    cpad = (-C) % 128
    leaf_bounds = np.full((C + cpad, 6), BIG, np.float32)
    leaf_bounds[:, 3:6] = -BIG
    leaf_bounds[:C, 0:3] = bmin_all[leaf_nodes]
    leaf_bounds[:C, 3:6] = bmax_all[leaf_nodes]
    return tables_from_numpy(nsc, geo_shade, leaf_bounds, bvh.builder, device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (brute force over clusters, chunked)
# ---------------------------------------------------------------------------


def _chunks(tables: ClusterTables, n: int, device):
    """(rays per chunk, clusters per group): about 2**22 (CPU) or 2**24
    (CUDA) ray-triangle pairs per step, so a 256k-ray call fits in memory."""
    budget = 1 << (24 if device.type == "cuda" else 22)
    r = max(1, min(n, budget // K))
    g = max(1, min(tables.num_clusters, budget // (r * K)))
    return r, g


def _cluster_tests(tables, c0, c1, o, d, mint, maxt):
    """(ok, t) over (R, (c1-c0)*K) ray-triangle pairs, as the shim tests."""
    rec = tables.tri[c0:c1].reshape(-1, TRI_F)
    real = (tables.geo_shade[c0:c1, _S_FACE] >= 0.0).reshape(-1)
    t, u, v, ok = moller_trumbore_edges(
        o[:, None, :], d[:, None, :],
        rec[None, :, 0:3], rec[None, :, 3:6], rec[None, :, 6:9],
    )
    ok = ok & real[None, :] & (t >= mint[:, None]) & (t <= maxt[:, None])
    return ok, t, rec


def _miss_shade(device):
    col = torch.zeros(SH_ROWS, dtype=torch.float32, device=device)
    col[_S_FACE] = -1.0
    col[_S_LIGHT] = -1.0
    col[list(_MISS_ONE_ROWS)] = 1.0
    return col


def trace_plain(tables: ClusterTables, rays: torch.Tensor) -> torch.Tensor:
    """Nearest hit, brute force: rays (8, N) -> (40, N) rows."""
    n = rays.shape[1]
    out = torch.zeros((OUT_ROWS, n), dtype=torch.float32, device=rays.device)
    r, g = _chunks(tables, n, rays.device)
    C = tables.num_clusters
    for s in range(0, n, r):
        e = min(n, s + r)
        o = rays[0:3, s:e].T
        d = rays[3:6, s:e].T
        mint = rays[6, s:e]
        maxt = rays[7, s:e]
        t0 = torch.clamp(maxt, max=BIG)
        tbest = t0
        cbest = torch.zeros(e - s, dtype=torch.int64, device=rays.device)
        kbest = torch.zeros_like(cbest)
        for c0 in range(0, C, g):
            ok, t, _ = _cluster_tests(tables, c0, min(C, c0 + g), o, d, mint, maxt)
            tt = torch.where(ok, t, BIG)
            # argmin takes the first minimum: the lowest cluster, then the
            # lowest k, as the shim's per-cluster strict '<' does
            idx = torch.argmin(tt, dim=1)
            gmin = tt.gather(1, idx[:, None])[:, 0]
            improved = (gmin < tbest) & (gmin < BIG)
            tbest = torch.where(improved, gmin, tbest)
            cbest = torch.where(improved, c0 + idx // K, cbest)
            kbest = torch.where(improved, idx % K, kbest)
        _winner_rows(out[:, s:e], tables, o, d, ~(tbest >= t0), cbest, kbest)
    return out


def _winner_rows(blk, tables, o, d, hit, cbest, kbest) -> None:
    """Rows 0-33 of the nearest hit into ``blk`` (40, R): the winner's
    attributes (the miss sentinel where ``hit`` is False) and its exact
    (t, u, v) recompute."""
    shade = tables.geo_shade[cbest.clamp(min=0), :, kbest]  # (R, 32)
    shade = torch.where(hit[:, None], shade, _miss_shade(o.device))
    face = shade[:, _S_FACE]
    valid = face >= 0.0
    tt, uu, vv, _ = moller_trumbore(o, d, shade[:, 0:3], shade[:, 3:6], shade[:, 6:9])
    blk[0] = torch.where(valid, tt, BIG)
    blk[1] = torch.where(valid, uu, 0.0)
    blk[2] = torch.where(valid, vv, 0.0)
    blk[3] = face
    blk[4:28] = shade[:, 0:24].T
    blk[28:33] = shade[:, _S_LIGHT:_S_HASUV + 1].T
    blk[33] = torch.where(valid, cbest.to(torch.float32), 0.0)


def occluded_plain(tables: ClusterTables, rays: torch.Tensor) -> torch.Tensor:
    """Any hit, brute force: rays (8, N) -> (8, N) rows, row 0 = blocked."""
    n = rays.shape[1]
    out = torch.zeros((ANY_ROWS, n), dtype=torch.float32, device=rays.device)
    r, g = _chunks(tables, n, rays.device)
    C = tables.num_clusters
    for s in range(0, n, r):
        e = min(n, s + r)
        o = rays[0:3, s:e].T
        d = rays[3:6, s:e].T
        blocked = torch.zeros(e - s, dtype=torch.bool, device=rays.device)
        for c0 in range(0, C, g):
            ok, _, rec = _cluster_tests(
                tables, c0, min(C, c0 + g), o, d, rays[6, s:e], rays[7, s:e]
            )
            blocked |= (ok & (rec[None, :, 9] > 0.0)).any(dim=1)
        out[0, s:e] = blocked.to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# Plain walks: the kernels' traversal, one node per lane per step
# ---------------------------------------------------------------------------

_LEAF_LANES = 8192  # lanes whose clusters one leaf step tests at a time


def _walk(tables: ClusterTables, rays: torch.Tensor, tmax, leaf):
    """Walk every live lane (maxt >= 0) through its octant's stackless
    preorder as the kernels do: each step loads one node, slab-tests it
    against ``tmax`` (read anew each step) and follows c+1 into an entered
    inner node, else the escape link. ``leaf(lanes, cid, count)`` tests the
    entered clusters and returns (tests per lane, lanes that are done).
    Returns the per-lane (visits, steps, tests) as int64."""
    n = rays.shape[1]
    dev = rays.device
    o, d, mint = rays[0:3].T, rays[3:6].T, rays[6]
    inv = 1.0 / torch.where(d.abs() < 1e-20, 1e-20, d)
    n_nodes = tables.node_scalars.shape[1]
    nodes = tables.node_scalars.reshape(-1, NODE_F)
    octant = (d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0) * 1
    base = octant.long() * n_nodes
    c = torch.where(rays[7] >= 0.0, 0, n_nodes).long()
    visits, steps, tests = (torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(3))
    while True:
        live = (c < n_nodes).nonzero()[:, 0]
        if live.numel() == 0:
            return visits, steps, tests
        rec = nodes[base[live] + c[live]]
        steps[live] += 1
        t0 = (rec[:, 0:3] - o[live]) * inv[live]
        t1 = (rec[:, 3:6] - o[live]) * inv[live]
        tnear = torch.minimum(t0, t1).amax(1)
        tfar = torch.maximum(t0, t1).amin(1)
        hit = (tnear <= tfar) & (tfar >= mint[live]) & (tnear <= tmax[live])
        count = rec[:, 7].long()
        c[live] = torch.where(hit & (count == 0), c[live] + 1, rec[:, 6].long())
        entered = hit & (count > 0)
        lanes = live[entered]
        visits[lanes] += 1
        cid, cnt = rec[entered, 8].long(), count[entered]
        for s in range(0, lanes.numel(), _LEAF_LANES):
            sl = slice(s, s + _LEAF_LANES)
            n_tests, done = leaf(lanes[sl], cid[sl], cnt[sl])
            tests[lanes[sl]] += n_tests
            c[lanes[sl][done]] = n_nodes


def _leaf_tests(tables, rays, lanes, cid, count):
    """(ok, t, records) of lanes x the <= 128 triangles of their clusters,
    k < count, inside each ray's [mint, maxt]."""
    rec = tables.tri[cid]  # (R, K, 12)
    t, _, _, ok = moller_trumbore_edges(
        rays[0:3, lanes].T[:, None, :], rays[3:6, lanes].T[:, None, :],
        rec[..., 0:3], rec[..., 3:6], rec[..., 6:9],
    )
    k = torch.arange(K, device=rays.device)
    ok = ok & (k[None] < count[:, None])
    ok = ok & (t >= rays[6, lanes, None]) & (t <= rays[7, lanes, None])
    return ok, t, rec


def _nearest_walk(tables: ClusterTables, rays: torch.Tensor):
    """The nearest-hit walk: per lane (tbest, winner cluster (-1: none),
    winner k, visits, node steps, triangle tests). A leaf keeps the
    lexicographically least (t, k) below the lane's tbest, as the kernel's
    strict '<' over k does."""
    n = rays.shape[1]
    dev = rays.device
    tbest = torch.clamp(rays[7], max=BIG).clone()
    cbest = torch.full((n,), -1, dtype=torch.int64, device=dev)
    kbest = torch.zeros(n, dtype=torch.int64, device=dev)

    def leaf(lanes, cid, count):
        ok, t, _ = _leaf_tests(tables, rays, lanes, cid, count)
        tt = torch.where(ok, t, float("inf"))
        k = torch.argmin(tt, dim=1)  # the first of equal minima: the least k
        tmin = tt.gather(1, k[:, None])[:, 0]
        better = tmin < tbest[lanes]
        won = lanes[better]
        tbest[won] = tmin[better]
        cbest[won] = cid[better]
        kbest[won] = k[better]
        return count, torch.zeros_like(better)

    return (tbest, cbest, kbest, *_walk(tables, rays, tbest, leaf))


def trace_walk_plain(tables: ClusterTables, rays: torch.Tensor) -> torch.Tensor:
    """Nearest hit by the kernels' walk: rays (8, N) -> (40, N) rows, the
    diagnostics (visits, node steps, triangle tests) in rows 34-36."""
    _, cbest, kbest, visits, steps, tests = _nearest_walk(tables, rays)
    out = torch.zeros((OUT_ROWS, rays.shape[1]), dtype=torch.float32, device=rays.device)
    _winner_rows(out, tables, rays[0:3].T, rays[3:6].T, cbest >= 0, cbest, kbest)
    out[34:37] = torch.stack([visits, steps, tests]).to(torch.float32)
    return out


def trace_nofetch_plain(tables: ClusterTables, rays: torch.Tensor) -> torch.Tensor:
    """The nofetch instance's plain version: rays (8, N) -> (6, N), the rows
    NOFETCH_ROWS of ``trace_walk_plain`` (t, face, cluster, visits, node
    steps, triangle tests) without the winner's attribute rows: t is the
    walk's own, face the one value read of the winner's attributes."""
    tbest, cbest, kbest, visits, steps, tests = _nearest_walk(tables, rays)
    face = torch.where(cbest >= 0, tables.geo_shade[cbest.clamp(min=0), _S_FACE, kbest], -1.0)
    valid = face >= 0.0
    return torch.stack([
        torch.where(valid, tbest, BIG), face, torch.where(valid, cbest.to(torch.float32), 0.0),
        visits.to(torch.float32), steps.to(torch.float32), tests.to(torch.float32),
    ])


def occluded_walk_plain(tables: ClusterTables, rays: torch.Tensor) -> torch.Tensor:
    """Any hit by the kernels' walk: rays (8, N) -> (8, N) rows, row 0
    blocked, rows 1-3 visits, node steps and triangle tests. A leaf counts
    the triangles that can block up to and including its first blocker in k
    order, as the kernel's loop does before it stops."""
    n = rays.shape[1]
    dev = rays.device
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)

    def leaf(lanes, cid, count):
        ok, _, rec = _leaf_tests(tables, rays, lanes, cid, count)
        k = torch.arange(K, device=dev)
        can_block = (rec[..., 9] != 0.0) & (k[None] < count[:, None])
        hits = ok & can_block
        hit_any = hits.any(1)
        first = torch.where(hit_any, hits.to(torch.int8).argmax(1), K)
        n_tests = (can_block & (k[None] <= first[:, None])).sum(1)
        blocked[lanes[hit_any]] = True
        return n_tests, hit_any

    visits, steps, tests = _walk(tables, rays, rays[7], leaf)
    out = torch.zeros((ANY_ROWS, n), dtype=torch.float32, device=dev)
    out[0] = blocked.to(torch.float32)
    out[1:4] = torch.stack([visits, steps, tests]).to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def build_library() -> "tuple[str, str]":
    """Compile csrc/cluster_trace.cu for sm_90a into the build directory
    (once per source hash). Returns (library path, compiler output)."""
    return cuda_build.build_library(SOURCE, "libkazen_trace")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kz_trace_nearest.argtypes = [p, p, i, p, p, p, i, i, p]
    lib.kz_trace_nearest.restype = i
    lib.kz_trace_nearest_nofetch.argtypes = [p, p, i, p, p, p, i, i, p]
    lib.kz_trace_nearest_nofetch.restype = i
    lib.kz_trace_any_hit.argtypes = [p, p, i, p, p, i, i, p]
    lib.kz_trace_any_hit.restype = i
    lib.kz_error_string.argtypes = [i]
    lib.kz_error_string.restype = ctypes.c_char_p
    return lib


# both replace kazen_tpu/accel/cluster_trace.py:_make_kernel (line 696), the
# nearest hit with any_hit=False and the any hit with any_hit=True
NEAREST = CudaKernel("cluster_trace_nearest", "kazen_tpu/accel/cluster_trace.py:696")
ANY_HIT = CudaKernel("cluster_trace_any_hit", "kazen_tpu/accel/cluster_trace.py:696")
# the nearest hit's lab instance without the winner's attribute fetch (the
# counterpart of KAZEN_TRACE_ABLATE=nofetch, kazen_tpu/accel/cluster_trace.py:514);
# only lab/kernel_ablate.py launches it
NEAREST_NOFETCH = CudaKernel("cluster_trace_nearest_nofetch",
                             "kazen_tpu/accel/cluster_trace.py:696")

# A drain round of the kernels runs cooperatively (the warp tests one pending
# lane's cluster at a time) when at least this many of the warp's 32 lanes
# hold no pending leaf; otherwise each pending lane tests its own cluster.
# 33 never drains cooperatively, 0 always does. Chosen by the sweep of
# chip_smoke.py's phase 4 on the main path's launches (PERF.md): the
# smallest value no slower than 33 on any launch of the stand-in pass.
COOP_MIN_IDLE = 8


def _check_inputs(tables: ClusterTables, rays: torch.Tensor) -> None:
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be (8, N) float32, got {tuple(rays.shape)} {rays.dtype}")
    if rays.shape[1] >= 2**31:
        raise ValueError("too many rays for one launch")
    for name in ("node_scalars", "geo_shade", "tri"):
        t = getattr(tables, name)
        if t.device != rays.device or t.dtype != torch.float32:
            raise ValueError(f"tables.{name} must be float32 on {rays.device}")
        if not t.is_contiguous():
            raise ValueError(f"tables.{name} must be contiguous")
    if not rays.is_contiguous():
        raise ValueError("rays must be contiguous")
    if tables.tri.shape[1:] != (K, TRI_F) or (
        tables.node_scalars.shape[0] != N_ORDERS or tables.node_scalars.shape[2] != NODE_F
    ):
        raise ValueError("malformed trace tables")
    if rays.device.type != "cuda":
        raise ValueError(f"the trace kernels take CUDA tensors, got {rays.device}")


def _raise_on(code: int, kernel: CudaKernel) -> None:
    if code != 0:
        msg = _library().kz_error_string(code).decode()
        raise RuntimeError(f"{kernel.name} launch failed: {msg} ({code})")


def _launch_nearest(tables, rays, min_idle, rows, entry, kernel) -> torch.Tensor:
    _check_inputs(tables, rays)
    n = rays.shape[1]
    out = torch.empty((rows, n), dtype=torch.float32, device=rays.device)
    if n == 0:
        return out
    n_nodes = tables.node_scalars.shape[1]
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        code = getattr(_library(), entry)(
            rays.data_ptr(), tables.node_scalars.data_ptr(), n_nodes,
            tables.tri.data_ptr(), tables.geo_shade.data_ptr(), out.data_ptr(),
            n, min_idle, stream,
        )
    kernel.launches += 1
    _raise_on(code, kernel)
    return out


def trace_cuda(tables: ClusterTables, rays: torch.Tensor,
               min_idle: int = COOP_MIN_IDLE) -> torch.Tensor:
    """Nearest-hit kernel: rays (8, N) on a CUDA device -> (40, N) rows.
    ``min_idle`` is the kernel's drain threshold (``COOP_MIN_IDLE``); the
    rows do not depend on it."""
    return _launch_nearest(tables, rays, min_idle, OUT_ROWS, "kz_trace_nearest", NEAREST)


def trace_nofetch_cuda(tables: ClusterTables, rays: torch.Tensor,
                       min_idle: int = COOP_MIN_IDLE) -> torch.Tensor:
    """The nearest-hit kernel's nofetch instance: rays (8, N) on a CUDA
    device -> (6, N), rows NOFETCH_ROWS of ``trace_cuda``'s output."""
    return _launch_nearest(tables, rays, min_idle, len(NOFETCH_ROWS),
                           "kz_trace_nearest_nofetch", NEAREST_NOFETCH)


def occluded_cuda(tables: ClusterTables, rays: torch.Tensor,
                  min_idle: int = COOP_MIN_IDLE) -> torch.Tensor:
    """Any-hit kernel: rays (8, N) on a CUDA device -> (8, N) rows; ``min_idle``
    as for ``trace_cuda``."""
    _check_inputs(tables, rays)
    n = rays.shape[1]
    out = torch.empty((ANY_ROWS, n), dtype=torch.float32, device=rays.device)
    if n == 0:
        return out
    lib = _library()
    n_nodes = tables.node_scalars.shape[1]
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        code = lib.kz_trace_any_hit(
            rays.data_ptr(), tables.node_scalars.data_ptr(), n_nodes,
            tables.tri.data_ptr(), out.data_ptr(), n, min_idle, stream,
        )
    ANY_HIT.launches += 1
    _raise_on(code, ANY_HIT)
    return out


# ---------------------------------------------------------------------------
# Public API: CPU tensors take the plain version, CUDA tensors the kernel
# ---------------------------------------------------------------------------


def pack_rays(o, d, mint, maxt) -> torch.Tensor:
    """(8, N) float32 [o3, d3, mint, maxt]."""
    n = o.shape[0]
    ot, dt = o.T.to(torch.float32), d.T.to(torch.float32)
    with metrics.sync("accel/cluster_trace.py:pack_rays as_tensor(mint)",
                      not isinstance(mint, torch.Tensor)):
        mint = torch.as_tensor(mint, dtype=torch.float32, device=o.device)
    with metrics.sync("accel/cluster_trace.py:pack_rays as_tensor(maxt)",
                      not isinstance(maxt, torch.Tensor)):
        maxt = torch.as_tensor(maxt, dtype=torch.float32, device=o.device)
    return torch.cat([ot, dt, mint.expand(n)[None], maxt.expand(n)[None]], dim=0).contiguous()


def trace_rays(tables: ClusterTables, rays: torch.Tensor) -> torch.Tensor:
    if rays.device.type == "cuda":
        return trace_cuda(tables, rays)
    if rays.device.type == "cpu":
        return trace_plain(tables, rays)
    raise ValueError(f"unsupported device {rays.device}")


def occluded_rays(tables: ClusterTables, rays: torch.Tensor) -> torch.Tensor:
    if rays.device.type == "cuda":
        return occluded_cuda(tables, rays)
    if rays.device.type == "cpu":
        return occluded_plain(tables, rays)
    raise ValueError(f"unsupported device {rays.device}")


@metrics.traced("trace.nearest")
def trace(tables: ClusterTables, o, d, mint, maxt) -> torch.Tensor:
    """Nearest hit + the winner's shading attributes: (40, N) rows."""
    return trace_rays(tables, pack_rays(o, d, mint, maxt))


@metrics.traced("trace.any_hit")
def occluded(tables: ClusterTables, o, d, mint, maxt) -> torch.Tensor:
    """Any-hit shadow query ignoring primary-invisible light faces: (N,) bool."""
    return occluded_rays(tables, pack_rays(o, d, mint, maxt))[0] > 0.0
