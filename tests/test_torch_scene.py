"""kazen_tpu_torch's scene compiler against kazen_tpu's on one description:
the geometry, material and light tables equal exactly, and so do the
cluster trace tables (which proves the same BVH and the same collapse)."""
import dataclasses

import numpy as np
import pytest
import torch

from kazen_tpu.accel import native as native_j
from kazen_tpu_torch.accel import bvh as bvh_t
from kazen_tpu_torch.accel import cluster_trace as ct_t
from kazen_tpu_torch.scene import compiler as comp_t
from kazen_tpu_torch.scene import description as DT

from torch_port_helpers import (
    assert_static_equal,
    base_textured_scene,
    compile_port,
    compile_reference,
    jax_baseline_configs,
    materials_scene,
    multi_cluster_scene,
    port_from_reference,
    textured_scene,
    to_port,
)

EXACT = (
    "V", "F", "N", "UV", "face_shade", "face_mesh", "mesh_material", "mesh_light",
    "mesh_has_normals", "mesh_has_uvs", "light_mesh", "light_radiance",
    "light_primary_vis", "light_cdf", "light_faces", "light_inv_area", "bg_color",
    "bg_intensity", "cam_to_world", "sample_to_camera", "cam_near", "cam_far",
)


@pytest.fixture(scope="module", params=["multi_cluster", "materials"])
def both(request):
    desc = {"multi_cluster": multi_cluster_scene, "materials": materials_scene}[
        request.param
    ]()
    return compile_reference(desc), compile_port(desc)


@pytest.mark.parametrize("name", EXACT)
def test_scene_arrays_equal(both, name):
    (a_j, _), (a_t, _) = both
    np.testing.assert_array_equal(
        getattr(a_t, name).numpy(), np.asarray(getattr(a_j, name)), err_msg=name
    )


def test_materials_equal(both):
    (a_j, _), (a_t, _) = both
    for f in dataclasses.fields(a_t.materials):
        np.testing.assert_array_equal(
            getattr(a_t.materials, f.name).numpy(),
            np.asarray(getattr(a_j.materials, f.name)),
            err_msg=f.name,
        )


@pytest.mark.parametrize("name", ["geo_shade", "node_scalars", "leaf_bounds"])
def test_trace_tables_equal(both, name):
    """Same BVH, same collapse, same octant orders: face and cluster ids
    match the reference exactly. The reference also pads its node table to
    a multiple of 32 rows, which no walk reaches; the port keeps the live
    rows of all 8 octant orders."""
    (a_j, _), (a_t, _) = both
    tt = a_t.trace_tables
    want_builder = "native" if native_j.available() else "numpy"
    assert tt.builder == want_builder
    want = np.asarray(getattr(a_j.trace_tables, name), np.float32)
    if name == "node_scalars":
        assert want.shape[0] == 8  # the reference orders these scenes by octant too
        want = want[:, : int(want[0, 0, 6])]
    np.testing.assert_array_equal(getattr(tt, name).numpy(), want)


def test_single_order_serves_every_octant(both):
    """A packed node table with one order (the reference keeps one for
    scenes beyond its scalar memory) carries across as that order in all 8
    octant slots, without its padding rows."""
    (a_j, _), (a_t, _) = both
    nsc = np.asarray(a_j.trace_tables.node_scalars, np.float32)
    got = ct_t.octant_orders(nsc[:1])
    live = a_t.trace_tables.node_scalars[0].numpy()
    assert got.shape == (8,) + live.shape
    for o in range(8):
        np.testing.assert_array_equal(got[o], live)


def test_triangle_records_follow_geo_shade(both):
    """The kernels' (C, 128, 12) records hold p0, e1 = p1 - p0, e2 = p2 - p0
    of the same triangles, and the blocks flag drops invisible lights."""
    _, (a_t, _) = both
    tt = a_t.trace_tables
    gs = tt.geo_shade
    assert tt.tri.shape == (tt.num_clusters, 128, 12)
    np.testing.assert_array_equal(tt.tri[:, :, 0:3].numpy(), gs[:, 0:3].transpose(1, 2).numpy())
    np.testing.assert_array_equal(
        tt.tri[:, :, 3:6].numpy(), (gs[:, 3:6] - gs[:, 0:3]).transpose(1, 2).numpy()
    )
    real = gs[:, 24] >= 0
    inv_light = (gs[:, 25] >= 0) & (gs[:, 26] == 0)
    np.testing.assert_array_equal(tt.tri[:, :, 9].numpy() > 0, (real & ~inv_light).numpy())
    assert bool(inv_light.any())  # the scene's light is primary-invisible


def test_static_equal(both):
    (a_j, s_j), (_, s_t) = both
    assert_static_equal(s_t, s_j, a_j)


def test_scene_from_numpy_round_trip(both):
    """kazen_tpu's compiled scene carried across equals the port's compile."""
    (a_j, s_j), (a_t, s_t) = both
    a_r, s_r = port_from_reference(a_j, s_j)
    assert s_r == s_t
    for name in EXACT:
        assert torch.equal(getattr(a_r, name), getattr(a_t, name)), name
    for f in dataclasses.fields(a_t.materials):
        assert torch.equal(getattr(a_r.materials, f.name), getattr(a_t.materials, f.name))
    for name in ("node_scalars", "geo_shade", "leaf_bounds", "tri"):
        assert torch.equal(getattr(a_r.trace_tables, name), getattr(a_t.trace_tables, name))


def _con2_small():
    """BASELINE's config 4 (con-2) at 24x14: a lat-long image background,
    and no material field textured."""
    desc = jax_baseline_configs().config_scene(4)
    desc.camera.width, desc.camera.height = 24, 14
    return desc


CARRIED = {
    # description, the material fields it textures
    "multi_cluster": (multi_cluster_scene, ()),
    "textured": (textured_scene, ("base", "metallic", "roughness", "normal")),
    "base_textured": (base_textured_scene, ("base",)),
    "con2": (_con2_small, ()),
}


@pytest.mark.parametrize("name", list(CARRIED))
def test_carried_scene_derives_textured_fields(name):
    """kazen_tpu's compile carried across derives ``textured_fields`` from
    its material table, so its static equals the port's compile field for
    field."""
    make, fields = CARRIED[name]
    desc = make()
    _, s_r = port_from_reference(*compile_reference(desc))
    _, s_t = compile_port(desc)
    assert s_r == s_t
    assert s_r.textured_fields == fields
    assert s_r.has_image_textures == (name != "multi_cluster")


def test_numpy_builder_builds_the_native_tree():
    """The numpy fallback builds the native builder's tree on a small mesh:
    the same nodes, boxes and escape links, and each leaf holds the same
    faces, though in another order -- which is why the packed tables
    record the builder and the tests compare like with like."""
    rng = np.random.RandomState(4)
    V = rng.rand(300, 3).astype(np.float32)
    F = rng.randint(0, 300, (500, 3)).astype(np.int32)
    a = bvh_t.build_bvh(V, F, leaf_size=8, backend="native")
    b = bvh_t.build_bvh(V, F, leaf_size=8, backend="numpy")
    assert (a.builder, b.builder) == ("native", "numpy")
    for name in ("bounds_min", "bounds_max", "skip", "prim_offset", "prim_count"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    for off, cnt in zip(a.prim_offset, a.prim_count):
        assert sorted(a.prim_faces[off:off + cnt]) == sorted(b.prim_faces[off:off + cnt])
    assert sorted(a.prim_faces) == list(range(len(F)))


def _with(desc, **changes):
    return dataclasses.replace(desc, **changes)


def _feature_scene(case):
    """The small multi-cluster scene with one feature of the cases below."""
    desc = to_port(multi_cluster_scene(width=8, height=8))
    m0 = desc.meshes[0]
    if case == "dielectric":
        desc.meshes[0] = dataclasses.replace(m0, bsdf=DT.RoughDielectric())
    elif case == "image_texture":
        tex = DT.ImageTexture(data=np.ones((2, 2, 3), np.float32))
        desc.meshes[0] = dataclasses.replace(m0, bsdf=DT.KazenStandard(base_color=tex))
    elif case == "env_importance":
        desc = _with(desc, background=DT.Background(texture=(0.2, 0.2, 0.2), importance=True))
    elif case == "normals_integrator":
        desc = _with(desc, integrator=DT.SimpleIntegrator(kind="normals"))
    elif case == "pmj02bn":
        desc = _with(desc, sampler=DT.Sampler(kind="pmj02bn"))
    return desc


FEATURES = ["dielectric", "image_texture", "env_importance", "normals_integrator", "pmj02bn"]


@pytest.mark.parametrize("case", FEATURES + ["obj"])
def test_unported_features_raise(case, tmp_path):
    """What the port still refuses is a texture file in a format it has no
    decoder for (JPEG; ROADMAP §C), also in a scene that uses each ported
    feature, and in one whose mesh is read from an OBJ file."""
    desc = _feature_scene(case)
    m0 = desc.meshes[0]
    if case == "obj":
        obj = tmp_path / "mesh.obj"
        obj.write_text("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nf 1 2 3 4\n")
        desc.meshes[0] = dataclasses.replace(m0, filename=str(obj))
    jpeg = tmp_path / "albedo.jpg"
    jpeg.write_bytes(b"\xff\xd8\xff\xe0" + bytes(60))
    tex = DT.ImageTexture(filename=str(jpeg))
    desc.meshes[1] = dataclasses.replace(desc.meshes[1], bsdf=DT.Lambertian(albedo=tex))
    with pytest.raises(NotImplementedError, match="JPEG"):
        comp_t.compile_scene(desc, device="cpu")


@pytest.mark.parametrize("case", FEATURES)
def test_ported_features_compile(case):
    """Each feature the compiler refused before this slice compiles, with
    the static fields that route it."""
    _, s_t = comp_t.compile_scene(_feature_scene(case), device="cpu")
    want = {
        "dielectric": ("btypes_present", (0, 7, 8)),
        "image_texture": ("has_image_textures", True),
        "env_importance": ("env_res", (256, 512)),
        "normals_integrator": ("integrator_kind", "normals"),
        "pmj02bn": ("sampler_kind", "pmj02bn"),
    }[case]
    assert getattr(s_t, want[0]) == want[1]


def test_compile_defaults_to_cuda():
    """The entry point runs on the card unless the caller asks for the CPU,
    and never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        comp_t.compile_scene(to_port(multi_cluster_scene(width=8, height=8)))
