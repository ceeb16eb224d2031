"""kazen_tpu_torch's debug integrators (integrate/simple.py: normals, ao,
whitted, path_mats) against kazen_tpu's on the CPU.

The scene is the multi-cluster box with a mirror and a dielectric quad (so
whitted follows specular chains) and a box filter, so that each pixel holds
one lane (a gaussian film spreads a lane over 25 pixels). Limits are
test_torch_render.py's: rtol 1e-3 / atol 1e-4 on >= 99% of pixels or lanes,
channel means within 0.5%, rays within 0.1%.

Whitted's shadow ray ends exactly at the light point it tests, so its
nearest hit on the light lies at t ~ maxt, and the last bit of the distance
decides whether the light occludes itself. The reference's own whitted,
run op by op and run under jit (which lets XLA contract products into
FMAs), differs on about 12% of lanes of this scene. So whitted is held per
lane to the reference run op by op, and through render() (which jits) by
its channel means and ray count.
"""
import dataclasses

import numpy as np
import pytest
import torch

from kazen_tpu.integrate import render as render_j
from kazen_tpu.scene import description as DJ
from kazen_tpu.utils.metrics import RenderMetrics as MetricsJ
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.integrate import simple as simple_t
from kazen_tpu_torch.utils.metrics import RenderMetrics as MetricsT

from scenes import make_mesh
from torch_port_helpers import compile_port, compile_reference, multi_cluster_scene

KINDS = ["normals", "ao", "whitted", "path_mats"]


def _scene(kind):
    desc = multi_cluster_scene(width=24, height=24)
    desc.meshes = list(desc.meshes) + [
        make_mesh([-0.8, 0.2, 0.9], [0, 0.6, 0], [0.6, 0, 0], bsdf=DJ.Mirror()),
        make_mesh([0.2, 0.2, 0.6], [0, 0.6, 0], [0.6, 0, 0], bsdf=DJ.Dielectric()),
    ]
    return dataclasses.replace(
        desc, integrator=DJ.SimpleIntegrator(kind=kind, max_depth=3),
        rfilter=DJ.RFilter(kind="box"),
    )


@pytest.mark.parametrize("kind", KINDS)
def test_render_matches_reference(kind):
    desc = _scene(kind)
    (a_j, s_j), (a_t, s_t) = compile_reference(desc), compile_port(desc)
    assert s_t.integrator_kind == kind and render_t.li_fn_for(s_t) is simple_t.LI_FNS[kind]
    m_j, m_t = MetricsJ(), MetricsT()
    img_j = np.asarray(render_j.render(a_j, s_j, spp=1, metrics=m_j))
    img_t = render_t.render(a_t, s_t, spp=1, metrics=m_t, device="cpu").numpy()
    assert img_j.mean() > 0.01
    if kind != "whitted":  # see the module's docstring
        lanes = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(axis=-1)
        assert lanes.mean() >= 0.99, lanes.mean()
    np.testing.assert_allclose(img_t.mean((0, 1)), img_j.mean((0, 1)), rtol=5e-3)
    rays_j, rays_t = m_j.summary()["rays"], m_t.summary()["rays"]
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)
    assert m_t.passes[0].lanes == 24 * 24


def test_whitted_lanes_match_reference():
    """li_whitted per lane against the reference's, both run op by op."""
    import jax.numpy as jnp

    from kazen_tpu.accel.intersect import Rays as RaysJ
    from kazen_tpu.integrate import simple as simple_j
    from kazen_tpu.samplers import streams as streams_j
    from kazen_tpu_torch.integrate import camera as cam_t
    from kazen_tpu_torch.samplers import streams as streams_t

    desc = _scene("whitted")
    (a_j, s_j), (a_t, s_t) = compile_reference(desc), compile_port(desc)
    spec_t = render_t.sampler_spec(s_t, "cpu")
    px, py = render_t.pixel_grid(s_t, "cpu")
    st_t = streams_t.init_stream(spec_t, px, py, 0)
    st_t, jitter = streams_t.next_pixel_2d(spec_t, st_t)
    st_t, ap = streams_t.next_2d(spec_t, st_t)
    rays = cam_t.sample_ray(a_t, s_t, torch.stack([px, py], -1).to(torch.float32) + jitter, ap)
    spec_j = render_j.sampler_spec(s_j)
    st_j = streams_j.init_stream(
        spec_j, px.numpy().astype(np.uint32), py.numpy().astype(np.uint32), 0
    )
    st_j, _ = streams_j.next_pixel_2d(spec_j, st_j)
    st_j, _ = streams_j.next_2d(spec_j, st_j)
    _, li_j, nr_j = simple_j.li_whitted(
        a_j, s_j, spec_j, st_j, RaysJ(*(jnp.asarray(x.numpy()) for x in rays))
    )
    _, li_t, nr_t = simple_t.li_whitted(a_t, s_t, spec_t, st_t, rays)
    li_j, li_t = np.asarray(li_j), li_t.numpy()
    lanes = np.isclose(li_t, li_j, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert lanes.mean() >= 0.99, lanes.mean()
    np.testing.assert_allclose(li_t.mean(0), li_j.mean(0), rtol=5e-3)
    assert float(nr_t) == float(nr_j)


def test_whitted_depth_cap_and_specular_chain():
    """whitted runs at most 16 bounces whatever max_depth says, and its
    specular branch continues through the mirror: more rays than one per
    camera ray."""
    desc = dataclasses.replace(_scene("whitted"), integrator=DJ.SimpleIntegrator(
        kind="whitted", max_depth=40))
    a_t, s_t = compile_port(desc)
    calls = []
    real = simple_t.intersect

    def counting(scene, rays):
        calls.append(rays.o.shape[0])
        return real(scene, rays)

    simple_t.intersect = counting
    try:
        m = MetricsT()
        img = render_t.render(a_t, s_t, spp=1, metrics=m, device="cpu")
    finally:
        simple_t.intersect = real
    assert len(calls) == 2 * 16  # a path trace and a shadow test per bounce
    assert bool(torch.isfinite(img).all())
    assert m.summary()["rays"] > 24 * 24


def test_render_progress_line(capsys):
    a_t, s_t = compile_port(_scene("normals"))
    render_t.render(a_t, s_t, spp=2, verbose=True, device="cpu")
    err = capsys.readouterr().err
    assert "2/2" in err and "eta" in err, err
