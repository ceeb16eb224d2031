"""The Cornell box of BASELINE.json's configurations 2, 4 and 5, with one
lat-long sphere: a frozen copy of the scene code of
``examples/baseline_configs.py`` (``cornell_box``, ``make_sphere``,
``config_scene``), written against a description module ``D`` so that the
program and the reference each build it with their own classes.

The configuration's JSON gives the frame (``width``, ``height``), the
sampler (``sampler``, ``sample_count``), ``max_depth``, ``regularization``,
the sphere (``center``, ``radius``, ``n_theta``, ``n_phi``, ``bsdf``) and
an optional lat-long ``background`` of two bands.
"""
from __future__ import annotations

import numpy as np


def quad(corner, edge_u, edge_v, flip=False):
    """Two-triangle quad with normals + uvs. Normal = edge_u x edge_v."""
    c = np.asarray(corner, np.float32)
    eu = np.asarray(edge_u, np.float32)
    ev = np.asarray(edge_v, np.float32)
    verts = np.stack([c, c + eu, c + eu + ev, c + ev])
    n = np.cross(eu, ev)
    n = n / np.linalg.norm(n)
    if flip:
        n = -n
        faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    else:
        faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    normals = np.tile(n, (4, 1)).astype(np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return verts, faces, normals, uvs


def make_mesh(D, corner, eu, ev, bsdf=None, light=None):
    v, f, n, uv = quad(corner, eu, ev)
    return D.Mesh(vertices=v, faces=f, normals=n, uvs=uv, bsdf=bsdf, light=light)


def make_sphere(D, center, radius, n_theta=24, n_phi=48):
    """A lat-long sphere of 2 (n_theta - 1) n_phi faces with smooth normals
    and uvs; the grid is built in float64 and cast once to float32."""
    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    verts = (np.asarray(center) + radius * pts).astype(np.float32)
    normals = pts.astype(np.float32)
    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    uvs = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)
    return D.Mesh(vertices=verts, faces=np.asarray(faces, np.int32), normals=normals,
                  uvs=uvs.astype(np.float32))


def _bsdf(D, spec):
    kind = spec["kind"]
    if kind == "ggx":
        return D.GGX(albedo=D.ConstantTexture(tuple(spec["albedo"])),
                     roughness=spec["roughness"])
    if kind == "kiss":
        return D.KazenStandard(
            base_color=D.ConstantTexture(tuple(spec["base_color"])),
            roughness=D.ConstantTexture((spec["roughness"],) * 3),
            metallic=D.ConstantTexture((spec["metallic"],) * 3),
        )
    if kind == "diffuse":
        return D.Diffuse(tuple(spec["albedo"]))
    raise ValueError(f"unknown bsdf kind {kind!r}")


def _background(D, spec):
    if spec is None:
        return None
    env = np.zeros((spec["height"], spec["width"], 3), np.float32)
    env[:spec["split_row"]] = spec["top"]
    env[spec["split_row"]:] = spec["bottom"]
    return D.Background(texture=D.ImageTexture(data=env, colorspace="linear"),
                        intensity=spec["intensity"])


def build(D, config: dict):
    """The description of ``config``: the box (12 faces, a primary-invisible
    area light under the ceiling, box filter) and the sphere."""
    wb = D.Diffuse((0.725, 0.71, 0.68))
    red = D.Diffuse((0.63, 0.065, 0.05))
    green = D.Diffuse((0.14, 0.45, 0.091))
    meshes = [
        make_mesh(D, [-1, 0, -1], [0, 0, 2], [2, 0, 0], bsdf=wb),  # floor, normal +y
        make_mesh(D, [-1, 2, -1], [2, 0, 0], [0, 0, 2], bsdf=wb),  # ceiling, -y
        make_mesh(D, [-1, 0, 1], [0, 2, 0], [2, 0, 0], bsdf=wb),  # back wall, -z
        make_mesh(D, [-1, 0, -1], [0, 2, 0], [0, 0, 2], bsdf=red),  # left wall, +x
        make_mesh(D, [1, 0, -1], [0, 0, 2], [0, 2, 0], bsdf=green),  # right wall, -x
        make_mesh(D, [-0.3, 1.98, -0.3], [0.6, 0, 0], [0, 0, 0.6],
                  bsdf=D.Diffuse((0, 0, 0)),
                  light=D.AreaLight(color=(1.0, 1.0, 1.0), intensity=20.0)),
    ]
    sp = config["sphere"]
    sphere = make_sphere(D, sp["center"], sp["radius"], sp["n_theta"], sp["n_phi"])
    sphere.bsdf = _bsdf(D, sp["bsdf"])
    meshes.append(sphere)
    cam = D.PerspectiveCamera(
        width=config["width"], height=config["height"], fov=60.0,
        to_world=D.lookat(origin=[0, 1, -2.5], target=[0, 1, 0], up=[0, 1, 0]),
    )
    return D.Scene(
        meshes=meshes,
        camera=cam,
        sampler=D.Sampler(kind=config["sampler"], sample_count=config["sample_count"],
                          seed=config["seed"]),
        integrator=D.PathMis(max_depth=config["max_depth"],
                             regularization=config["regularization"]),
        rfilter=D.RFilter(kind="box"),
        background=_background(D, config.get("background")),
    )
