"""The Textured scene, the repository's stand-in for kazen-con-1's whole
pipeline: a frozen copy of the smoke run's ``textured_scene`` and its
helpers (the repository root's card script), written against a description module ``D`` so that the program
and the reference each build it with their own classes, and drawing every
image from the run's seed.

The Cornell box of ``cornell.build`` (its floor a normal map of smooth
tangent-space bumps over diffuse), a lat-long kiss sphere whose base colour
(sRGB stripes with noise) and roughness are images, a roughconductor, a
roughplastic and a roughdielectric quad, and a lat-long sky with a sun,
importance-sampled; the gaussian filter, mip filtering with the anisotropic
probes. The configuration's JSON gives the frame, the sampler, the depth,
the sphere's tessellation and images' sizes, the normal map's and the
sky's sizes; ``seed`` seeds the sampler and every image.
"""
from __future__ import annotations

import numpy as np


def _quad(D, corner, eu, ev, bsdf=None, light=None):
    c = np.asarray(corner, np.float32)
    eu = np.asarray(eu, np.float32)
    ev = np.asarray(ev, np.float32)
    verts = np.stack([c, c + eu, c + eu + ev, c + ev])
    n = np.cross(eu, ev)
    n = n / np.linalg.norm(n)
    return D.Mesh(
        vertices=verts,
        faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.tile(n, (4, 1)).astype(np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        bsdf=bsdf,
        light=light,
    )


def _sphere(D, center, radius, nu, nv, bsdf):
    """A lat-long sphere of 2 nu nv faces (poles included)."""
    c = np.asarray(center, np.float32)
    uu, vv = np.meshgrid(
        np.linspace(0.0, 2.0 * np.pi, nu + 1, dtype=np.float32),
        np.linspace(0.0, np.pi, nv + 1, dtype=np.float32),
        indexing="ij",
    )
    normals = np.stack(
        [np.sin(vv) * np.cos(uu), np.cos(vv), np.sin(vv) * np.sin(uu)], -1
    ).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu / (2.0 * np.pi), vv / np.pi], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b = ((i + 1) * (nv + 1) + j).reshape(-1)
    cc = ((i + 1) * (nv + 1) + j + 1).reshape(-1)
    d = (i * (nv + 1) + j + 1).reshape(-1)
    faces = np.stack([np.stack([a, b, cc], 1), np.stack([a, cc, d], 1)], 1)
    return D.Mesh(
        vertices=(c + radius * normals).astype(np.float32),
        faces=faces.reshape(-1, 3).astype(np.int32),
        normals=normals,
        uvs=uvs.astype(np.float32),
        bsdf=bsdf,
    )


def _cornell_meshes(D, floor_bsdf):
    """The box (floor, ceiling, back, left and right walls) and its
    primary-invisible area light under the ceiling."""
    wall = D.Diffuse((0.725, 0.71, 0.68))
    return [
        _quad(D, [-1, 0, -1], [0, 0, 2], [2, 0, 0], floor_bsdf),
        _quad(D, [-1, 2, -1], [2, 0, 0], [0, 0, 2], wall),
        _quad(D, [-1, 0, 1], [0, 2, 0], [2, 0, 0], wall),
        _quad(D, [-1, 0, -1], [0, 2, 0], [0, 0, 2], D.Diffuse((0.63, 0.065, 0.05))),
        _quad(D, [1, 0, -1], [0, 0, 2], [0, 2, 0], D.Diffuse((0.14, 0.45, 0.091))),
        _quad(
            D, [-0.3, 1.98, -0.3], [0.6, 0, 0], [0, 0, 0.6], D.Diffuse((0, 0, 0)),
            light=D.AreaLight(color=(1.0, 1.0, 1.0), intensity=20.0),
        ),
    ]


def bump_normals(res, rng):
    """A tangent-space normal map of smooth random bumps, as linear RGB."""
    x = np.arange(res) * (2 * np.pi / res)
    h = sum(
        rng.random() * np.sin(k * x[:, None] + rng.random() * 6.0) * np.cos(k * x[None, :])
        for k in (3, 7, 13)
    )
    gy, gx = np.gradient(h)
    n = np.stack([-gx * res / 40.0, -gy * res / 40.0, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (0.5 * n + 0.5).astype(np.float32)


def kiss_base_image(rng, res):
    """The sphere's sRGB base colour: diagonal stripes with noise, (res, res,
    3) in [0, 1]."""
    u = np.linspace(0.0, 1.0, res, dtype=np.float32)
    stripes = 0.5 + 0.5 * np.sin(2 * np.pi * 24 * (u[:, None] + 0.3 * u[None, :]))
    base = np.stack([0.2 + 0.6 * stripes, 0.3 + 0.3 * (1 - stripes), 0.7 - 0.4 * stripes], -1)
    return np.clip(base + 0.1 * rng.random((res, res, 3)), 0.0, 1.0).astype(np.float32)


def sky_image(rng, spec):
    """The lat-long sky: a dim level with noise and a bright sun."""
    h, w = spec["height"], spec["width"]
    sky = np.full((h, w, 3), spec["level"], np.float32)
    sky += spec["noise"] * rng.random((h, w, 3)).astype(np.float32)
    (r0, r1), (c0, c1) = spec["sun_rows"], spec["sun_cols"]
    sky[r0:r1, c0:c1] = spec["sun"]
    return sky


def build(D, config: dict):
    """The description of ``config`` (``seed`` draws the images in the order
    base colour, roughness, normal map, sky)."""
    rng = np.random.default_rng(int(config["seed"]))
    sp = config["sphere"]
    res = sp["image_size"]
    base = kiss_base_image(rng, res)
    lo, span = sp["roughness_range"]
    rough = (lo + span * rng.random((res, res))).astype(np.float32)
    sphere = _sphere(
        D, sp["center"], sp["radius"], sp["nu"], sp["nv"],
        D.KazenStandard(
            base_color=D.ImageTexture(data=base),
            roughness=D.ImageTexture(data=rough, colorspace="linear"),
            metallic=D.ConstantTexture((sp["metallic"],) * 3),
        ),
    )
    floor = D.NormalMap(
        nested=D.Diffuse((0.725, 0.71, 0.68)),
        normals=D.ImageTexture(data=bump_normals(config["normal_map_size"], rng),
                               colorspace="linear"),
    )
    meshes = _cornell_meshes(D, floor)
    quads = [
        _quad(D, [-0.95, 1.25, 0.9], [0, 0.5, 0], [0.5, 0, 0],
              D.RoughConductor(material="Au", alpha=0.3)),
        _quad(D, [0.45, 1.25, 0.9], [0, 0.5, 0], [0.5, 0, 0],
              D.RoughPlastic(alpha=0.25, kd=(0.2, 0.45, 0.7))),
        _quad(D, [-0.3, 0.05, -0.5], [0, 0.4, 0], [0.6, 0, 0],
              D.RoughDielectric(roughness=0.2)),
    ]
    background = D.Background(
        texture=D.ImageTexture(data=sky_image(rng, config["sky"]), colorspace="linear"),
        intensity=1.0, importance=True,
    )
    cam = D.PerspectiveCamera(
        width=config["width"], height=config["height"], fov=60.0,
        to_world=D.lookat(origin=[0, 1, -2.5], target=[0, 1, 0], up=[0, 1, 0]),
    )
    return D.Scene(
        meshes=meshes + [sphere] + quads,
        camera=cam,
        sampler=D.Sampler(kind=config["sampler"], sample_count=config["sample_count"],
                          seed=config["seed"]),
        integrator=D.PathMis(max_depth=config["max_depth"],
                             regularization=config["regularization"]),
        rfilter=D.RFilter(kind=config["rfilter"]),
        background=background,
    )
