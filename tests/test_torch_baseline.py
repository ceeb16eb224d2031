"""BASELINE.json's configurations on the port
(kazen_tpu_torch/examples/baseline_configs.py) against the JAX example
(examples/baseline_configs.py, loaded by path and not modified) on the CPU.

- Scene parity: configs 1-4 of the JAX example, carried across with
  ``to_port``, compile to the same tables as the port's own
  ``config_scene``, and to kazen_tpu's geometry, material and trace tables.
- Render parity: configs 1-4 at 1 spp, about 24 pixels wide (config 4
  24x14): per-lane radiance within rtol 1e-3 / atol 1e-4 on >= 99% of
  lanes, channel means within 0.5%, rays within 0.1% (PERF.md §2's gate).
- Multi-spp parity: config 1 at 16x16, 4 spp, through both packages'
  render(): the images under the same gate, per pixel.
- Config 5, shortened to 16x16 and 3 steps on one scene carried across
  with scene_from_numpy and one target: losses within rtol 1e-3, the
  material table after each step within 1e-4.
- The entry points repaired to default to the card raise without CUDA.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.diff import inverse as inverse_j
from kazen_tpu.integrate import camera as cam_j
from kazen_tpu.integrate import path_mis as pm_j
from kazen_tpu.integrate import render as render_j
from kazen_tpu.samplers import streams as streams_j
from kazen_tpu.shade import medium as medium_j
from kazen_tpu_torch.core import dpdf as dpdf_t
from kazen_tpu_torch.diff import inverse as inverse_t
from kazen_tpu_torch.examples import baseline_configs as bc
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.samplers import tables as tables_t
from kazen_tpu_torch.shade import medium as medium_t

from torch_port_helpers import (
    compile_port,
    compile_reference,
    jax_baseline_configs,
    port_from_reference,
)

EXACT = (
    "V", "F", "N", "UV", "face_shade", "face_mesh", "mesh_material", "mesh_light",
    "mesh_has_normals", "mesh_has_uvs", "light_mesh", "light_radiance",
    "light_primary_vis", "light_cdf", "light_faces", "light_inv_area", "bg_color",
    "bg_tex", "bg_intensity", "cam_to_world", "sample_to_camera", "cam_near", "cam_far",
    "aperture_radius", "focus_distance", "env_row_cdf", "env_col_cdf", "env_pdf",
)
SMALL = {1: (24, 24), 2: (24, 24), 3: (24, 24), 4: (24, 14)}


@pytest.fixture(scope="module")
def example():
    return jax_baseline_configs()


def _resized(desc, size):
    desc.camera.width, desc.camera.height = size
    return desc


def _assert_gate(got, want, rays_got=None, rays_want=None):
    got, want = got.reshape(-1, 3), want.reshape(-1, 3)
    lanes = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    assert lanes.mean() >= 0.99, lanes.mean()
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=5e-3)
    if rays_want is not None:
        assert abs(rays_got - rays_want) <= 1e-3 * rays_want, (rays_got, rays_want)


def _tables_equal(a, b):
    """Two port scenes compiled from equal descriptions: every table equal."""
    for name in EXACT:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for group in ("materials", "textures"):
        for f in dataclasses.fields(getattr(a, group)):
            x, y = getattr(getattr(a, group), f.name), getattr(getattr(b, group), f.name)
            assert torch.equal(x, y), (group, f.name)
    for name in ("node_scalars", "geo_shade", "leaf_bounds", "tri"):
        assert torch.equal(getattr(a.trace_tables, name), getattr(b.trace_tables, name)), name


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_port_scene_equals_example(example, n):
    """The port's config_scene(n) compiles to the tables of the JAX
    example's config_scene(n) carried across, at the published size, spp
    and face count."""
    a_e, s_e = compile_port(example.config_scene(n))
    a_p, s_p = compile_port(bc.config_scene(n))
    assert s_p == s_e
    assert int(a_p.F.shape[0]) == bc.FACES[n]
    assert not s_p.use_megakernel
    _tables_equal(a_p, a_e)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_example_tables_match_reference(example, n):
    """kazen_tpu's compile of the same configuration: geometry, material,
    texture and trace tables equal, the static fields equal."""
    desc = example.config_scene(n)
    a_j, s_j = compile_reference(desc)
    a_t, s_t = compile_port(desc)
    a_r, s_r = port_from_reference(a_j, s_j)
    assert s_r == s_t
    _tables_equal(a_r, a_t)


def _li_reference(arrays, static):
    spec = render_j.sampler_spec(static)
    ys, xs = np.meshgrid(np.arange(static.height), np.arange(static.width), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    st = streams_j.init_stream(spec, px.astype(np.uint32), py.astype(np.uint32), 0)
    st, jitter = streams_j.next_pixel_2d(spec, st)
    ps = jnp.stack([jnp.asarray(px), jnp.asarray(py)], -1).astype(jnp.float32) + jitter
    st, ap = streams_j.next_2d(spec, st)
    rays = cam_j.sample_ray(arrays, static, ps, ap)
    _, li, nrays = pm_j.li_wavefront(arrays, static, spec, st, rays)
    return np.asarray(li), float(nrays)


def _li_port(scene, static):
    from kazen_tpu_torch.integrate import camera as cam_t
    from kazen_tpu_torch.integrate import path_mis as pm_t
    from kazen_tpu_torch.samplers import streams as streams_t

    spec = render_t.sampler_spec(static, "cpu")
    px, py = render_t.pixel_grid(static, scene.device)
    st = streams_t.init_stream(spec, px, py, 0)
    st, jitter = streams_t.next_pixel_2d(spec, st)
    ps = torch.stack([px, py], -1).to(torch.float32) + jitter
    st, ap = streams_t.next_2d(spec, st)
    rays = cam_t.sample_ray(scene, static, ps, ap)
    _, li, nrays = pm_t.li_wavefront(scene, static, spec, st, rays)
    return li.numpy(), float(nrays)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_pass_matches_reference(example, n):
    """Sample pass 0 of config n at about 24 pixels wide, the port's own
    description against the JAX example's through kazen_tpu."""
    a_j, s_j = compile_reference(_resized(example.config_scene(n), SMALL[n]))
    a_t, s_t = compile_port(bc.at_size(bc.config_scene(n), *SMALL[n]))
    li_j, rays_j = _li_reference(a_j, s_j)
    li_t, rays_t = _li_port(a_t, s_t)
    assert li_j.mean() > 0.01
    _assert_gate(li_t, li_j, rays_t, rays_j)


def test_multi_spp_render_matches_reference(example):
    """Config 1 at 16x16, 4 spp, through both packages' render(): the
    multi-spp loop and each sample's jump."""
    desc = _resized(example.config_scene(1, spp=4), (16, 16))
    img_j = np.asarray(render_j.render(*compile_reference(desc)))
    img_t = render_t.render(*compile_port(bc.at_size(bc.config_scene(1, spp=4), 16, 16)),
                            device="cpu").numpy()
    assert img_t.shape == (16, 16, 3) and img_j.mean() > 0.01
    _assert_gate(img_t, img_j)


def test_config5_steps_match_reference(example):
    """Config 5 shortened: config 2's geometry at 16x16, one target (the
    reference's render at 8 spp with the sphere's roughness 0.35), then 3
    Adam steps of 2 spp in both packages on one scene."""
    a_j, s_j = compile_reference(_resized(example.config_scene(2, spp=8), (16, 16)))
    a_t, s_t = port_from_reference(a_j, s_j)
    mats = a_j.materials._replace(
        roughness=a_j.materials.roughness.at[-1].set(bc.TRUE_ROUGHNESS))
    target = np.array(render_j.render(a_j._replace(materials=mats), s_j, spp=8))
    want = bc.with_roughness(a_t, bc.TRUE_ROUGHNESS).materials.roughness
    np.testing.assert_array_equal(want.numpy(), np.asarray(mats.roughness))

    steps = {"jax": [], "port": []}

    def record(key):
        def cb(it, loss, params):
            steps[key].append((loss, {f: np.array(v.detach() if torch.is_tensor(v) else v)
                                      for f, v in params["materials"].items()}))
        return cb

    inverse_j.optimize(a_j, s_j, target, steps=3, spp_per_step=2, param_keys=("materials",),
                       callback=record("jax"))
    inverse_t.optimize(a_t, s_t, torch.from_numpy(target), steps=3, spp_per_step=2,
                       param_keys=("materials",), callback=record("port"))
    assert len(steps["port"]) == len(steps["jax"]) == 3
    for (loss_t, p_t), (loss_j, p_j) in zip(steps["port"], steps["jax"]):
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-3)
        assert set(p_t) <= set(p_j)
        for f in p_t:
            np.testing.assert_allclose(p_t[f], p_j[f], rtol=0, atol=1e-4, err_msg=f)
    assert steps["port"][-1][1]["roughness"][-1] != pytest.approx(0.2)  # it moved


@pytest.mark.parametrize("call", [
    lambda: tables_t.make_pmj02bn_spec(4, seed=1),
    lambda: dpdf_t.build(np.ones(4, np.float32)),
    lambda: medium_t.make_nonscatter((0.5, 0.25, 1.0)),
], ids=["make_pmj02bn_spec", "dpdf.build", "make_nonscatter"])
def test_entry_points_default_to_cuda(call):
    """The card is the default device; without CUDA the call raises and
    never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_nonscatter_matches_reference():
    """make_nonscatter on the CPU when asked, against kazen_tpu's."""
    got = medium_t.make_nonscatter((0.5, 0.25, 1.0), distance=2.0, device="cpu")
    want = medium_j.make_nonscatter((0.5, 0.25, 1.0), distance=2.0)
    assert got.sigma.device.type == "cpu"
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(want.sigma), rtol=1e-6)
    t = np.array([0.0, 0.5, 3.0], np.float32)
    np.testing.assert_allclose(medium_t.transmission(got, torch.from_numpy(t)).numpy(),
                               np.asarray(medium_j.transmission(want, jnp.asarray(t))),
                               rtol=1e-6)


def test_run_config_on_cpu():
    """run_config's figures on the CPU for config 1 at 2 spp: the published
    frame, K1/K2's wavefront route, rays and rates from its RenderMetrics."""
    res = bc.run_config(1, spp=2, device="cpu", verbose=False)
    img = res.pop("image")
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    assert (res["faces"], res["spp"], res["megakernel"]) == (540, 2, False)
    assert res["rays_per_pass"] > 64 * 64
    assert res["pixel_samples_per_s"] == pytest.approx(64 * 64 * 2 / res["render_s"])
    assert res["metrics"]["passes"] == 2
