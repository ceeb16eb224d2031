"""Brute-force ray queries for the reference.

``trace_rows`` returns the (40, N) rows the program's nearest-hit kernel
returns and its path tracer reads (0 t, 1 u, 2 v, 3 face or -1, 4-27 the
face's p0 p1 p2 n0 n1 n2 uv0 uv1 uv2, 28 light, 29 the light's primary
visibility, 30 material, 31 has normals, 32 has uvs, 33 a cluster id, here
0). ``occluded_rows`` answers a shadow query that faces of primary-invisible
lights never block. The test is Moller-Trumbore on the face's f32 edges, as
the kernel tests it; the nearest hit is the least t, ties to the lowest face.

Every ray is tested against every face, save that a mesh of more than
``CULL_FACES`` faces is skipped by the rays that miss a sphere around it
(its vertices' bounding sphere, grown by a thousandth): a triangle lies
inside the sphere around its vertices, so no hit is lost.
"""
from __future__ import annotations

import torch

from .kz.accel.intersect import moller_trumbore, moller_trumbore_edges

BIG = 3.0e38
ROWS = 40
CULL_FACES = 64
# rows of the miss column that hold 1 (p1.y, p2.x, n0.z, ...), so that the
# masked shading of a miss lane stays finite, as the kernel's miss column
_MISS_ONE_ROWS = (7, 11, 15, 18, 21)


class _Group:
    """Faces tested together: their ids, edges, and an optional sphere."""

    def __init__(self, ids, p0, e1, e2, blocks, sphere=None):
        self.ids, self.p0, self.e1, self.e2, self.blocks = ids, p0, e1, e2, blocks
        self.sphere = sphere


def _faces(scene):
    """(shade rows (Nf, 24), meta (Nf, 5), [_Group]) of a scene."""
    fs = scene.face_shade
    mesh = scene.face_mesh
    light = scene.mesh_light[mesh]
    lpv = torch.where(light >= 0, scene.light_primary_vis[light.clamp(min=0)], False)
    meta = torch.stack([
        light.to(torch.float32), lpv.to(torch.float32),
        scene.mesh_material[mesh].to(torch.float32),
        scene.mesh_has_normals[mesh].to(torch.float32),
        scene.mesh_has_uvs[mesh].to(torch.float32),
    ], 1)
    blocks = ~((light >= 0) & ~lpv)
    small, groups = [], []
    for m in torch.unique(mesh).tolist():
        ids = torch.nonzero(mesh == m)[:, 0]
        if ids.numel() <= CULL_FACES:
            small.append(ids)
            continue
        verts = fs[ids][:, 0:9].reshape(-1, 3).double()
        lo, hi = verts.min(0).values, verts.max(0).values
        center = (lo + hi) / 2
        radius = (verts - center).norm(dim=1).max() * 1.001 + 1e-6
        groups.append((ids, (center, radius)))
    out = []
    for ids, sphere in ([(torch.cat(small), None)] if small else []) + groups:
        ids = torch.sort(ids).values
        p0 = fs[ids, 0:3]
        out.append(_Group(ids, p0, fs[ids, 3:6] - p0, fs[ids, 6:9] - p0, blocks[ids], sphere))
    return fs, meta, out


def _candidates(group, o, d, mint, maxt):
    """The rays (indices) that can hit a face of ``group``."""
    if group.sphere is None:
        return None
    c, r = group.sphere
    oc = o.double() - c
    dd = d.double()
    a = (dd * dd).sum(-1)
    b = (oc * dd).sum(-1)
    cc = (oc * oc).sum(-1) - r * r
    disc = b * b - a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a = torch.clamp(a, min=1e-30)
    t0, t1 = (-b - sq) / a, (-b + sq) / a
    slack = 1e-3 * (1.0 + r / a.sqrt())
    ok = (disc >= 0) & (t1 >= mint.double() - slack) & (t0 <= maxt.double() + slack)
    return torch.nonzero(ok)[:, 0]


def _chunk(n_faces, device) -> int:
    budget = 1 << (24 if device.type == "cuda" else 21)
    return max(1, budget // max(1, n_faces))


def _tests(group, o, d, mint, maxt):
    t, _, _, ok = moller_trumbore_edges(o[:, None, :], d[:, None, :], group.p0[None],
                                        group.e1[None], group.e2[None])
    return ok & (t >= mint[:, None]) & (t <= maxt[:, None]), t


def _each_chunk(group, o, d, mint, maxt):
    """(ray indices, ok, t) over chunks of the group's candidate rays."""
    lanes = _candidates(group, o, d, mint, maxt)
    n = o.shape[0] if lanes is None else lanes.shape[0]
    step = _chunk(group.ids.shape[0], o.device)
    for s in range(0, n, step):
        idx = (torch.arange(s, min(n, s + step), device=o.device) if lanes is None
               else lanes[s:s + step])
        ok, t = _tests(group, o[idx], d[idx], mint[idx], maxt[idx])
        yield idx, ok, t


def _expand(n, mint, maxt, dev):
    return (torch.as_tensor(mint, dtype=torch.float32, device=dev).expand(n).contiguous(),
            torch.as_tensor(maxt, dtype=torch.float32, device=dev).expand(n).contiguous())


def trace_rows(scene, o, d, mint, maxt) -> torch.Tensor:
    """Nearest hit of each ray: (40, N) rows."""
    n = o.shape[0]
    dev = o.device
    fs, meta, groups = _faces(scene)
    mint, maxt = _expand(n, mint, maxt, dev)
    tbest = torch.full((n,), BIG, device=dev)
    fbest = torch.full((n,), fs.shape[0], dtype=torch.int64, device=dev)
    for g in groups:
        for idx, ok, t in _each_chunk(g, o, d, mint, maxt):
            tt = torch.where(ok, t, BIG)
            k = torch.argmin(tt, dim=1)
            tk = tt.gather(1, k[:, None])[:, 0]
            fk = g.ids[k]
            tb, fb = tbest[idx], fbest[idx]
            better = (tk < BIG) & ((tk < tb) | ((tk == tb) & (fk < fb)))
            tbest[idx] = torch.where(better, tk, tb)
            fbest[idx] = torch.where(better, fk, fb)
    hit = tbest < torch.clamp(maxt, max=BIG)
    best = torch.where(hit, fbest, 0)
    shade = fs[best]
    tr, ur, vr, _ = moller_trumbore(o, d, shade[:, 0:3], shade[:, 3:6], shade[:, 6:9])
    out = torch.zeros((ROWS, n), dtype=torch.float32, device=dev)
    out[0] = torch.where(hit, tr, BIG)
    out[1] = torch.where(hit, ur, 0.0)
    out[2] = torch.where(hit, vr, 0.0)
    out[3] = torch.where(hit, best.to(torch.float32), -1.0)
    out[4:28] = torch.where(hit[None], shade.T, 0.0)
    out[28:33] = torch.where(hit[None], meta[best].T, 0.0)
    out[28] = torch.where(hit, out[28], -1.0)
    for r in _MISS_ONE_ROWS:
        out[r] = torch.where(hit, out[r], 1.0)
    return out


def occluded_rows(scene, o, d, mint, maxt) -> torch.Tensor:
    """Whether a blocking face lies within [mint, maxt] of each ray: (N,)
    bool."""
    n = o.shape[0]
    dev = o.device
    _, _, groups = _faces(scene)
    mint, maxt = _expand(n, mint, maxt, dev)
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    for g in groups:
        for idx, ok, _ in _each_chunk(g, o, d, mint, maxt):
            out[idx] |= (ok & g.blocks[None]).any(dim=1)
    return out
