"""BASELINE.json's configuration 3, the kazen-con-1 kiss full stack
(``examples/baseline_configs.py:config_scene(3)``), written against a
description module ``D`` so that the program and the reference each build
it with their own classes: the Cornell box of ``cornell.build``, two
lat-long spheres and a thin-lens camera.

The configuration's JSON gives the frame, the sampler, ``max_depth``,
``regularization``, the two ``spheres`` (``center``, ``radius``,
``n_theta``, ``n_phi``, ``bsdf``) and ``thin_lens`` (``aperture_radius``,
``focus_distance``). A kiss ``bsdf`` names its base colour as an rgb or as
an image, its scalar parameters, and an optional ``normal_map`` image that
wraps it. The images are built from their description: ``checker`` (white
lines every ``every`` texels on black) or ``bump`` (the ``flat`` normal,
with every ``every``-th row's red at ``red``). Without ``thin_lens`` the
camera is ``cornell.build``'s pinhole.
"""
from __future__ import annotations

import numpy as np

from . import cornell


def _image(D, spec):
    n, k = spec["size"], spec["every"]
    if spec["image"] == "checker":
        img = np.zeros((n, n, 3), np.float32)
        img[::k, :] = 1.0
        img[:, ::k] = 1.0
    elif spec["image"] == "bump":
        img = np.full((n, n, 3), spec["flat"], np.float32)
        img[::k, :, 0] = spec["red"]
    else:
        raise ValueError(f"unknown image {spec['image']!r}")
    return D.ImageTexture(data=img, colorspace="linear")


def _kiss(D, spec):
    """A kiss material; the keys the spec leaves out keep their defaults."""
    base = spec["base_color"]
    kwargs = {"base_color": _image(D, base) if isinstance(base, dict)
              else D.ConstantTexture(tuple(base))}
    for key in ("roughness", "metallic"):
        if key in spec:
            kwargs[key] = D.ConstantTexture((spec[key],) * 3)
    for key in ("clearcoat", "sheen"):
        if key in spec:
            kwargs[key] = spec[key]
    bsdf = D.KazenStandard(**kwargs)
    if "normal_map" in spec:
        bsdf = D.NormalMap(nested=bsdf, normals=_image(D, spec["normal_map"]))
    return bsdf


def build(D, config: dict):
    """The description of ``config``: ``cornell.build``'s box, pinhole,
    sampler, integrator and box filter with no background, its sphere the
    first of ``config``, then the second sphere and the thin lens."""
    first, second = config["spheres"]
    scene = cornell.build(D, dict(config, background=None,
                                  sphere=dict(first, bsdf={"kind": "diffuse",
                                                           "albedo": [0.0, 0.0, 0.0]})))
    scene.meshes[-1].bsdf = _kiss(D, first["bsdf"])
    sphere = cornell.make_sphere(D, second["center"], second["radius"], second["n_theta"],
                                 second["n_phi"])
    sphere.bsdf = _kiss(D, second["bsdf"])
    scene.meshes.append(sphere)
    lens = config.get("thin_lens")
    if lens is not None:
        cam = scene.camera
        scene.camera = D.ThinlensCamera(
            width=cam.width, height=cam.height, fov=cam.fov, to_world=cam.to_world,
            aperture_radius=lens["aperture_radius"], focus_distance=lens["focus_distance"])
    return scene
