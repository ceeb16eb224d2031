"""Shared helpers of the tests that hold kazen_tpu_torch against kazen_tpu:
scene descriptions carried across, compiled scenes converted to numpy, the
small scenes the tests use, a gradient gate, and process groups run with a
timeout."""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from kazen_tpu.accel import native as native_j
from kazen_tpu.scene import description as DJ
from kazen_tpu.scene.compiler import compile_scene as compile_jax
from kazen_tpu_torch.accel import native as native_t
from kazen_tpu_torch.dist.multihost import free_port
from kazen_tpu_torch.scene import description as DT
from kazen_tpu_torch.scene.compiler import TEXTURE_FIELDS, scene_from_numpy
from kazen_tpu_torch.scene.compiler import compile_scene as compile_torch

from scenes import cornell_box, make_mesh, sphere_mesh

KISS = dict(base_color=(0.6, 0.4, 0.8), metallic=0.3, roughness=0.3)
KISS_COAT = dict(
    base_color=(0.2, 0.7, 0.3), metallic=0.6, roughness=0.15, anisotropy=0.4,
    specular=0.7, specular_tint=0.3, clearcoat=0.8, clearcoat_roughness=0.2,
    sheen=0.5, sheen_tint=0.6,
)


def to_port(x):
    """A kazen_tpu scene description as the same objects of the port's copy
    of description.py, class by class and field by field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(DT, type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    return x


def multi_cluster_scene(width=24, height=24, sampler="independent", spp=1,
                        visible_lights=False, regularization=False):
    """Cornell box + a kiss sphere (nu = nv = 24): 1,164 faces in several
    clusters, so the per-bounce permute runs."""
    extra = (
        sphere_mesh([0.0, 0.8, 0.3], 0.45, nu=24, nv=24, bsdf=DJ.KazenStandard(**KISS)),
    )
    lk = {"primary_visibility": True} if visible_lights else None
    return cornell_box(
        width=width, height=height, spp=spp, sampler=sampler, extra_meshes=extra,
        light_kwargs=lk, regularization=regularization,
    )


def materials_scene(width=16, height=16):
    """Cornell box + two kiss spheres with different parameters (clearcoat,
    sheen, anisotropy) beside the diffuse walls."""
    extra = (
        sphere_mesh([0.4, 0.5, 0.3], 0.3, nu=16, nv=12, bsdf=DJ.KazenStandard(**KISS)),
        sphere_mesh([-0.4, 0.5, 0.2], 0.3, nu=16, nv=12, bsdf=DJ.KazenStandard(**KISS_COAT)),
    )
    return cornell_box(width=width, height=height, extra_meshes=extra)


def single_cluster_scene(width=20, height=20):
    """Cornell box + a small kiss sphere: 108 faces, one cluster (the
    reference packs trace tables above 64 faces)."""
    extra = (sphere_mesh([0.0, 0.6, 0.2], 0.4, nu=8, nv=6, bsdf=DJ.KazenStandard(**KISS)),)
    return cornell_box(width=width, height=height, extra_meshes=extra)


def mixed_scene(width=16, height=16, sampler="independent", spp=1):
    """The megakernel's mixed-material scene: the Cornell box (primary-
    invisible light) plus one quad each of kiss, mirror, GGX, dielectric
    (where tests/test_megakernel.py puts them) and lambertian: 22 faces,
    every BSDF branch of the megakernel. The quads face the camera (-z):
    turned away, as in that test, the opaque ones shade to 0."""
    extra = (
        make_mesh(
            [-0.8, 0.0, 0.6], [0, 0.6, 0], [0.6, 0, 0],
            bsdf=DJ.KazenStandard(
                base_color=(0.7, 0.3, 0.2), metallic=0.4, roughness=0.35,
                clearcoat=0.6, sheen=0.4,
            ),
        ),
        make_mesh([0.2, 0.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=DJ.Mirror()),
        make_mesh(
            [-0.8, 0.8, 0.6], [0, 0.6, 0], [0.6, 0, 0],
            bsdf=DJ.GGX(albedo=(0.9, 0.7, 0.4), roughness=0.2),
        ),
        make_mesh([0.2, 0.8, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=DJ.Dielectric()),
        make_mesh(
            [-0.3, 1.3, 0.9], [0, 0.5, 0], [0.6, 0, 0],
            bsdf=DJ.Lambertian(albedo=DJ.ConstantTexture((0.3, 0.6, 0.5))),
        ),
    )
    return cornell_box(
        width=width, height=height, spp=spp, sampler=sampler, extra_meshes=extra
    )


def compile_reference(desc):
    """kazen_tpu's compile with its cluster trace tables packed (the CPU
    backend otherwise leaves them out, and so does a scene of <= 64 faces);
    K1/K2 then run through its shim, as the port always traces."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAZEN_PALLAS_TRACE", "1")
        arrays, static = compile_jax(desc, use_bvh=True)
    assert arrays.trace_tables is not None
    return arrays, static


def compile_port(desc):
    """The port's compile on the CPU, with the BVH builder that kazen_tpu
    has in this process. kazen_tpu compiles its native builder in place at
    first use, so a test process whose first use races another process's
    build runs on its numpy builder, whose leaves list their faces in
    another order; the port then runs its numpy builder too, and both
    packages build the same tree."""
    with pytest.MonkeyPatch.context() as mp:
        if not native_j.available():
            mp.setattr(native_t, "build", lambda V, F, leaf_size: None)
        return compile_torch(to_port(desc), device="cpu")


def reference_to_numpy(arrays, static):
    """kazen_tpu's compiled (SceneArrays, SceneStatic) in the form
    scene_from_numpy reads."""
    out = {}
    for name in (
        "V", "F", "N", "UV", "face_shade", "face_mesh", "mesh_material", "mesh_light",
        "mesh_has_normals", "mesh_has_uvs", "light_mesh", "light_radiance",
        "light_primary_vis", "light_cdf", "light_faces", "light_inv_area", "bg_color",
        "bg_intensity", "cam_to_world", "sample_to_camera", "cam_near", "cam_far",
        "aperture_radius", "focus_distance", "bg_tex", "env_row_cdf", "env_col_cdf",
        "env_pdf",
    ):
        out[name] = np.asarray(getattr(arrays, name))
    out["materials"] = {
        k: np.asarray(v) for k, v in arrays.materials._asdict().items()
    }
    out["textures"] = {k: np.asarray(v) for k, v in arrays.textures._asdict().items()}
    tt = arrays.trace_tables
    out["trace_tables"] = {
        "node_scalars": np.asarray(tt.node_scalars, np.float32),
        "geo_shade": np.asarray(tt.geo_shade, np.float32),
        "leaf_bounds": np.asarray(tt.leaf_bounds, np.float32),
    }
    return out, dataclasses.asdict(static)


def port_from_reference(arrays, static):
    """The port's scene built from kazen_tpu's compiled scene."""
    return scene_from_numpy(*reference_to_numpy(arrays, static), device="cpu")


def textured_fields_of(materials):
    """The texture fields that some row of a material table (either
    package's) names a texture in, in the port compiler's order."""
    return tuple(field for field, col in TEXTURE_FIELDS.items()
                 if (np.asarray(getattr(materials, col)) >= 0).any())


def assert_static_equal(s_t, s_j, a_j):
    """The port's compiled static fields equal kazen_tpu's, and its own
    ``textured_fields`` (kazen_tpu has none) are those that kazen_tpu's
    material table names a texture in."""
    for f in dataclasses.fields(s_t):
        if f.name != "textured_fields":
            assert getattr(s_t, f.name) == getattr(s_j, f.name), f.name
    assert s_t.textured_fields == textured_fields_of(a_j.materials)


def assert_carried_static_equal(s_r, s_t):
    """kazen_tpu's static carried across (port_from_reference) equals the
    port's compile, save for the fields kazen_tpu has none of, which keep
    the defaults (textured_fields None: every field may be textured)."""
    assert s_r.textured_fields is None
    assert dataclasses.replace(s_r, textured_fields=s_t.textured_fields) == s_t


def _bump_normals(res, seed):
    """A tangent-space normal map of smooth random bumps, as linear RGB."""
    rng = np.random.RandomState(seed)
    x = np.arange(res) * (2 * np.pi / res)
    h = sum(
        rng.rand() * np.sin(k * x[:, None] + rng.rand() * 6.0) * np.cos(k * x[None, :])
        for k in (2, 5, 9)
    )
    gy, gx = np.gradient(h)
    n = np.stack([-gx * res / 40.0, -gy * res / 40.0, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (0.5 * n + 0.5).astype(np.float32)


def sky_image(h, w, seed):
    """A lat-long sky: dim seeded noise and one bright sun blob."""
    rng = np.random.RandomState(seed)
    img = (0.05 + 0.05 * rng.rand(h, w, 3)).astype(np.float32)
    img[h // 4: h // 4 + max(h // 16, 2), w // 3: w // 3 + max(w // 16, 2)] = (60.0, 50.0, 35.0)
    return img


def textured_scene(width=24, height=24, sampler="pmj02bn", spp=4, max_depth=4, importance=True,
                   composite=True):
    """The box with this slice's features: a kiss sphere whose baseColor
    (sRGB image) and roughness (an image; with ``composite``, a colorramp
    over it, and a metallic blend under an image mask) are textures; a
    normal-mapped diffuse floor; roughconductor, roughplastic and
    roughdielectric quads; a lat-long sky with a sun, importance-sampled;
    mip filtering with EWA probes."""
    rng = np.random.RandomState(17)
    base = rng.rand(64, 64, 3).astype(np.float32)
    rough = DJ.ImageTexture(data=rng.rand(32, 32).astype(np.float32), colorspace="linear",
                            scale=2.0)
    mask = rng.rand(16, 16, 3).astype(np.float32)
    kiss = DJ.KazenStandard(base_color=DJ.ImageTexture(data=base), roughness=rough, clearcoat=0.4)
    if composite:
        kiss = dataclasses.replace(
            kiss,
            roughness=DJ.ColorRamp(input=rough, min=0.1, max=0.7),
            metallic=DJ.Blend(
                mask=DJ.ImageTexture(data=mask, colorspace="linear"),
                input1=DJ.ConstantTexture((0.1, 0.1, 0.1)),
                input2=DJ.ConstantTexture((0.6, 0.6, 0.6)),
            ),
        )
    extra = (
        sphere_mesh([0.0, 0.8, 0.3], 0.45, nu=24, nv=24, bsdf=kiss),
        make_mesh([-0.9, 0.1, 0.8], [0, 0.5, 0], [0.5, 0, 0],
                  bsdf=DJ.RoughConductor(material="Cu", alpha=0.4)),
        make_mesh([0.4, 0.1, 0.8], [0, 0.5, 0], [0.5, 0, 0],
                  bsdf=DJ.RoughPlastic(alpha=0.3, kd=(0.2, 0.5, 0.7))),
        make_mesh([-0.25, 1.25, 0.0], [0, 0.4, 0], [0.5, 0, 0],
                  bsdf=DJ.RoughDielectric(roughness=0.3)),
    )
    sky = DJ.Background(
        texture=DJ.ImageTexture(data=sky_image(32, 64, 3), colorspace="linear"),
        intensity=1.0, importance=importance,
    )
    desc = cornell_box(
        width=width, height=height, spp=spp, sampler=sampler, max_depth=max_depth,
        extra_meshes=extra, background=sky,
    )
    floor = desc.meshes[0]
    desc.meshes[0] = dataclasses.replace(floor, bsdf=DJ.NormalMap(
        nested=DJ.Diffuse((0.7, 0.7, 0.65)),
        normals=DJ.ImageTexture(data=_bump_normals(64, 5), colorspace="linear"),
    ))
    return desc


def base_textured_scene(width=24, height=24):
    """textured_scene without composite nodes, with the kiss sphere's
    roughness a constant and a plain diffuse floor: its materials texture
    their base colour alone (and the sky is an image)."""
    desc = textured_scene(width, height, composite=False)
    for i, mesh in enumerate(desc.meshes):
        if isinstance(mesh.bsdf, DJ.KazenStandard):
            desc.meshes[i] = dataclasses.replace(
                mesh, bsdf=dataclasses.replace(mesh.bsdf, roughness=DJ.ConstantTexture((0.3,) * 3)))
        elif isinstance(mesh.bsdf, DJ.NormalMap):
            desc.meshes[i] = dataclasses.replace(mesh, bsdf=mesh.bsdf.nested)
    return desc


def assert_grads_close(got, want, label=""):
    """The gradient gate: allclose(rtol=1e-3, atol=1e-3 * max|want|), per
    field of two dicts of arrays (a None or missing gradient is zeros)."""
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = got.get(k)
        g = np.zeros_like(w) if g is None else np.asarray(g, np.float64)
        atol = 1e-3 * float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=f"{label} {k}")


def run_ranks(script, world, args=(), timeout=240.0):
    """Run ``python -c script port rank world *args`` as ``world`` processes
    (the repository and tests/ on their path) and wait for all of them, at
    most ``timeout`` seconds together: on time-out every process is killed
    and the test fails. Each must exit 0; returns their outputs."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.path.join(repo, "tests"), os.environ.get("PYTHONPATH", "")]))
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(port), str(rank), str(world), *map(str, args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        pytest.fail(f"process group of {world} did not finish within {timeout} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-3000:]}"
    return outs


def write_xml_scene(tmp_path, extra=""):
    """The OBJ + XML pair of tests/test_io_cli.py:test_xml_import (a quad
    turned and scaled by its toWorld, a kiss material with clearcoat), with
    ``extra`` XML inside <scene>; returns the XML's path."""
    (tmp_path / "quad.obj").write_text(
        "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
        "vn 0 1 0\nvn 0 1 0\nvn 0 1 0\nvn 0 1 0\n"
        "f 1//1 2//2 3//3 4//4\n"
    )
    (tmp_path / "light.obj").write_text(
        "v -0.3 1.9 -0.3\nv 0.3 1.9 -0.3\nv 0.3 1.9 0.3\nv -0.3 1.9 0.3\n"
        "f 1 2 3 4\n"
    )
    xml = tmp_path / "scene.xml"
    xml.write_text(f"""<?xml version="1.0"?>
<scene>
  <integrator type="path_mis"><integer name="maxDepth" value="3"/></integrator>
  <sampler type="stratified"><integer name="sampleCount" value="4"/></sampler>
  <camera type="perspective">
    <integer name="width" value="12"/><integer name="height" value="12"/>
    <float name="fov" value="60"/>
    <transform name="toWorld">
      <lookat origin="0, 1, -3" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <rfilter type="gaussian"><float name="radius" value="2.0"/></rfilter>
  </camera>
  <mesh type="obj">
    <string name="filename" value="quad.obj"/>
    <transform name="toWorld"><rotate axis="0 1 0" angle="10"/><scale value="1.2"/></transform>
    <bsdf type="kazenstandard">
      <texture type="constanttexture" id="baseColor">
        <color name="color" value="0.6 0.3 0.2"/>
      </texture>
      <float name="clearcoat" value="0.3"/>
    </bsdf>
  </mesh>
  <mesh type="obj">
    <string name="filename" value="light.obj"/>
    <light type="area">
      <color name="color" value="1 1 1"/><float name="intensity" value="10"/>
    </light>
  </mesh>
  {extra}
</scene>
""")
    return str(xml)
