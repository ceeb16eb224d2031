"""Mitsuba/Nori-style XML scene importer (parser.cpp:10-305 semantics).

Parses the reference's scene schema 1:1 into the Python description layer:
tag->class map (parser.cpp:73-97), property tags including composed
<transform> (translate/matrix/rotate/scale/lookat, each LEFT-multiplied onto
the accumulator, parser.cpp:238-293), children routed by class and id
(kiss textures baseColor/metallic/roughness bsdf.cpp:1373-1395, blend
mask/input1/input2, scene background scene.cpp:115-121). Relative paths
resolve against the scene file's directory (main.cpp:52).

The port of ``kazen_tpu/scene/xml_io.py``: it builds the port's own
description classes (scene/description.py), field for field as the
reference builds its own.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from . import description as D


def _tokens(s: str):
    return [t for t in re.split(r"[,\s]+", s.strip()) if t]


def _vec3(s: str):
    v = [float(t) for t in _tokens(s)]
    if len(v) == 1:
        v = v * 3
    return tuple(v[:3])


class _Props:
    """Collected property tags of one element."""

    def __init__(self):
        self.values = {}
        self.transforms = {}

    def get(self, name, default=None):
        return self.values.get(name, default)

    def get_transform(self, name, default=None):
        return self.transforms.get(name, default)


def _parse_transform(node) -> np.ndarray:
    t = np.eye(4, dtype=np.float64)
    for child in node:
        tag = child.tag.lower()
        if tag == "translate":
            v = _vec3(child.attrib["value"])
            m = np.eye(4)
            m[:3, 3] = v
        elif tag == "scale":
            v = _vec3(child.attrib["value"])
            m = np.diag([v[0], v[1], v[2], 1.0])
        elif tag == "rotate":
            angle = np.deg2rad(float(child.attrib["angle"]))
            axis = np.asarray(_vec3(child.attrib["axis"]), np.float64)
            axis = axis / np.linalg.norm(axis)
            c, s = np.cos(angle), np.sin(angle)
            x, y, z = axis
            r = np.array(
                [
                    [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                    [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                    [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
                ]
            )
            m = np.eye(4)
            m[:3, :3] = r
        elif tag == "matrix":
            vals = [float(x) for x in _tokens(child.attrib["value"])]
            m = np.asarray(vals, np.float64).reshape(4, 4)
        elif tag == "lookat":
            m = np.asarray(
                D.lookat(
                    _vec3(child.attrib["origin"]),
                    _vec3(child.attrib["target"]),
                    _vec3(child.attrib["up"]),
                ),
                np.float64,
            )
        else:
            raise ValueError(f"unknown transform op <{tag}>")
        t = m @ t  # parser.cpp: transform = op * transform
    return t.astype(np.float32)


def _collect_props(node) -> _Props:
    p = _Props()
    for child in node:
        tag = child.tag.lower()
        name = child.attrib.get("name")
        if tag == "boolean":
            p.values[name] = child.attrib["value"].lower() == "true"
        elif tag == "integer":
            p.values[name] = int(child.attrib["value"])
        elif tag == "float":
            p.values[name] = float(child.attrib["value"])
        elif tag == "string":
            p.values[name] = child.attrib["value"]
        elif tag in ("color", "point", "vector"):
            p.values[name] = _vec3(child.attrib["value"])
        elif tag == "transform":
            p.transforms[name] = _parse_transform(child)
    return p


def _parse_texture(node, base_dir) -> D.Texture:
    kind = node.attrib["type"]
    p = _collect_props(node)
    if kind == "constanttexture":
        return D.ConstantTexture(color=p.get("color", (0.5, 0.5, 0.5)))
    if kind == "imagetexture":
        fn = p.get("filename")
        return D.ImageTexture(
            filename=os.path.join(base_dir, fn) if fn else None,
            scale=p.get("scale", 1.0),
            colorspace=p.get("colorspace", "srgb"),
        )
    if kind == "background":
        nested = None
        for child in node:
            if child.tag == "texture":
                nested = _parse_texture(child, base_dir)
        return D.Background(texture=nested, intensity=p.get("intensity", 1.0))
    if kind == "colorramp":
        nested = None
        for child in node:
            if child.tag == "texture":
                nested = _parse_texture(child, base_dir)
        return D.ColorRamp(input=nested, min=p.get("min", 0.0), max=p.get("max", 1.0))
    if kind == "blend":
        kids = {}
        for child in node:
            if child.tag == "texture":
                kids[child.attrib.get("id")] = _parse_texture(child, base_dir)
        return D.Blend(
            mask=kids.get("mask"),
            input1=kids.get("input1"),
            input2=kids.get("input2"),
            mode=p.get("mode", "mix"),
        )
    raise ValueError(f"unknown texture type {kind}")


def _parse_bsdf(node, base_dir) -> D.BSDF:
    kind = node.attrib["type"]
    p = _collect_props(node)
    textures = {}
    nested_bsdf = None
    for child in node:
        if child.tag == "texture":
            textures[child.attrib.get("id")] = _parse_texture(child, base_dir)
        elif child.tag == "bsdf":
            nested_bsdf = _parse_bsdf(child, base_dir)

    if kind == "diffuse":
        return D.Diffuse(albedo=p.get("albedo", (0.5, 0.5, 0.5)))
    if kind == "dielectric":
        return D.Dielectric(
            int_ior=p.get("intIOR", 1.5046), ext_ior=p.get("extIOR", 1.000277)
        )
    if kind == "mirror":
        return D.Mirror()
    if kind == "lambertian":
        albedo = next(iter(textures.values()), D.ConstantTexture())
        return D.Lambertian(albedo=albedo)
    if kind == "normalmap":
        normals = next(iter(textures.values()), None)
        return D.NormalMap(nested=nested_bsdf, normals=normals)
    if kind == "ggx":
        albedo = next(iter(textures.values()), D.ConstantTexture())
        return D.GGX(
            albedo=albedo,
            roughness=p.get("roughness", 0.5),
            anisotropy=p.get("anisotropy", 0.0),
        )
    if kind == "roughconductor":
        return D.RoughConductor(
            material=p.get("material", "Au"), alpha=p.get("alpha", 0.1)
        )
    if kind == "roughplastic":
        return D.RoughPlastic(
            alpha=p.get("alpha", 0.1),
            int_ior=p.get("intIOR", 1.5046),
            ext_ior=p.get("extIOR", 1.000277),
            kd=p.get("kd", (0.5, 0.5, 0.5)),
        )
    if kind == "roughdielectric":
        return D.RoughDielectric(
            roughness=p.get("roughness", 0.1),
            int_ior=p.get("intIOR", 1.5046),
            ext_ior=p.get("extIOR", 1.000277),
        )
    if kind == "kazenstandard":
        return D.KazenStandard(
            base_color=textures.get("baseColor", D.ConstantTexture((0.8,) * 3)),
            metallic=textures.get("metallic", D.ConstantTexture((0.0,) * 3)),
            roughness=textures.get("roughness", D.ConstantTexture((0.5,) * 3)),
            anisotropy=p.get("anisotropy", 0.0),
            specular=p.get("specular", 0.5),
            specular_tint=p.get("specularTint", 0.5),
            clearcoat=p.get("clearcoat", 0.0),
            clearcoat_roughness=p.get("clearcoatRoughness", 0.5),
            sheen=p.get("sheen", 0.0),
            sheen_tint=p.get("sheenTint", 0.5),
        )
    raise ValueError(f"unknown bsdf type {kind}")


def load_xml(path: str) -> D.Scene:
    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    if root.tag != "scene":
        raise ValueError("root element must be <scene>")

    scene = D.Scene(meshes=[], camera=None, background=None)
    for node in root:
        tag = node.tag
        if tag == "integrator":
            kind = node.attrib["type"]
            p = _collect_props(node)
            if kind == "path_mis":
                scene.integrator = D.PathMis(
                    max_depth=p.get("maxDepth", 5),
                    trace_bias=p.get("traceBias", 1e-3),
                    regularization=p.get("regularization", False),
                    accumulated_roughness=p.get("accumulatedRoughness", 0.5),
                )
            else:
                scene.integrator = D.SimpleIntegrator(kind=kind)
        elif tag == "sampler":
            p = _collect_props(node)
            scene.sampler = D.Sampler(
                kind=node.attrib["type"],
                sample_count=p.get("sampleCount", 1),
                seed=p.get("seed", 1),
            )
        elif tag == "camera":
            p = _collect_props(node)
            kw = dict(
                width=p.get("width", 1280),
                height=p.get("height", 720),
                to_world=p.get_transform("toWorld"),
                fov=p.get("fov", 30.0),
                near_clip=p.get("nearClip", 1e-4),
                far_clip=p.get("farClip", 1e4),
            )
            if node.attrib["type"] == "thinlens":
                scene.camera = D.ThinlensCamera(
                    aperture_radius=p.get("apertureRadius", 1.0),
                    focus_distance=p.get("focusDistance", 0.0),
                    **kw,
                )
            else:
                scene.camera = D.PerspectiveCamera(**kw)
            for child in node:
                if child.tag == "rfilter":
                    fp = _collect_props(child)
                    scene.rfilter = D.RFilter(
                        kind=child.attrib["type"],
                        radius=fp.get("radius", 2.0),
                        stddev=fp.get("stddev", 0.5),
                        b=fp.get("B", 1.0 / 3.0),
                        c=fp.get("C", 1.0 / 3.0),
                    )
        elif tag == "mesh":
            p = _collect_props(node)
            mesh = D.Mesh(
                filename=os.path.join(base_dir, p.get("filename")),
                to_world=p.get_transform("toWorld"),
            )
            for child in node:
                if child.tag == "bsdf":
                    mesh.bsdf = _parse_bsdf(child, base_dir)
                elif child.tag == "light":
                    lp = _collect_props(child)
                    mesh.light = D.AreaLight(
                        color=lp.get("color", (1.0, 1.0, 1.0)),
                        intensity=lp.get("intensity", 1.0),
                        primary_visibility=lp.get(
                            "lightPrimaryVisibility", False
                        ),
                    )
            scene.meshes.append(mesh)
        elif tag == "texture":
            if node.attrib.get("id") == "background":
                bg = _parse_texture(node, base_dir)
                if not isinstance(bg, D.Background):
                    bg = D.Background(texture=bg, intensity=1.0)
                scene.background = bg
    if scene.camera is None:
        scene.camera = D.PerspectiveCamera()
    return scene
