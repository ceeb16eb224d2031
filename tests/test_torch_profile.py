"""kazen_tpu_torch/lab/profile_pass2.py, the port of benchmarks/profile_pass2.py,
on the CPU.

The bounce-1 state (camera rays, intersect and prepare, the light pick and
area-light sample, the BSDF sample) is held to the same construction run
through kazen_tpu's functions, as the original builds it: integer fields
exact, float fields within rtol 1e-3 / atol 1e-4 on >= 99% of lanes (the
limits of tests/test_torch_render.py; the frameworks differ in the last bits
of transcendentals). Then the original's rows and the stage attribution run
on the CPU, where the attribution times PyTorch's operators in place of the
card's kernels.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.core import rng as rng_j
from kazen_tpu.integrate import camera as cam_j
from kazen_tpu.integrate import path_mis as pm_j
from kazen_tpu.integrate import render as render_j
from kazen_tpu.samplers import streams as streams_j
from kazen_tpu.shade import bsdf as bsdf_j
from kazen_tpu.shade import lights as lights_j
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.lab import profile_pass2 as pp2

from torch_port_helpers import compile_port, compile_reference, multi_cluster_scene

W, H = 32, 18


@pytest.fixture(scope="module")
def scenes():
    desc = multi_cluster_scene(width=W, height=H)
    return compile_reference(desc), compile_port(desc)


def _bounce1_reference(arrays, static):
    """benchmarks/profile_pass2.py's bounce1_rays, op by op."""
    spec = render_j.sampler_spec(static)
    ys, xs = np.meshgrid(np.arange(static.height), np.arange(static.width), indexing="ij")
    px = jnp.asarray(xs.reshape(-1).astype(np.uint32))
    py = jnp.asarray(ys.reshape(-1).astype(np.uint32))
    a, c = rng_j.advance_constants(0)
    jump = ((jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF)),
            (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF)))
    stream = streams_j.init_stream_jump(spec, px, py, jnp.uint32(0), jump)
    stream, jitter = streams_j.next_pixel_2d(spec, stream)
    ps = jnp.stack([px, py], -1).astype(jnp.float32) + jitter
    stream, ap = streams_j.next_2d(spec, stream)
    rays = cam_j.sample_ray(arrays, static, ps, ap)
    _, its = pm_j.intersect_prepare(arrays, rays)
    ctx = bsdf_j.make_ctx(scene=arrays, static=static, mat_id=its.material, uv=its.uv,
                          sh_frame=its.sh_frame, dpdu=its.dpdu,
                          wi=its.sh_frame.to_local(-rays.d), lod=None)
    stream, u_pick = streams_j.next_1d(spec, stream)
    stream, u_tri = streams_j.next_1d(spec, stream)
    stream, u_a = streams_j.next_1d(spec, stream)
    stream, u_b = streams_j.next_1d(spec, stream)
    pick = lights_j.select_uniform(static.num_lights, u_pick)
    ls = lights_j.sample_area_light(arrays, pick, its.p, u_tri, u_a, u_b)
    stream, s1 = streams_j.next_1d(spec, stream)
    stream, s2 = streams_j.next_2d(spec, stream)
    res = bsdf_j.sample_ctx(static, arrays, ctx, s1, s2, jnp.zeros(px.shape[0], jnp.float32))
    alive = its.valid
    return {
        "p": its.p, "d": its.sh_frame.to_world(res.wo), "cluster": its.cluster, "alive": alive,
        "shadow_d": ls.wi, "shadow_maxt": jnp.where(alive, ls.dist - static.trace_bias, -1.0),
        "pick": pick, "weight": res.weight, "pdf": res.pdf, "discrete": res.is_discrete,
    }


def test_bounce1_state_matches_reference(scenes):
    (a_j, s_j), (a_t, s_t) = scenes
    want = {k: np.asarray(v) for k, v in _bounce1_reference(a_j, s_j).items()}
    got = pp2.bounce1_state(a_t, s_t, render_t.sampler_spec(s_t, "cpu"))
    assert want["alive"].mean() > 0.5
    for k in ("cluster", "alive", "pick", "discrete"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), want[k].astype(np.int64)
                                      if k in ("cluster", "pick") else want[k], err_msg=k)
    for k in ("p", "d", "shadow_d", "shadow_maxt", "weight", "pdf"):
        g, w = getattr(got, k).numpy(), want[k]
        lanes = np.isclose(g, w, rtol=1e-3, atol=1e-4)
        lanes = lanes.all(-1) if lanes.ndim > 1 else lanes
        assert lanes.mean() >= 0.99, (k, lanes.mean())
    assert len(pp2.permute_columns(got)) == 12
    assert torch.cat(pp2.permute_columns(got), 1).shape == (W * H, 24)


def test_stage_rows_on_cpu(scenes, capsys):
    _, (a_t, s_t) = scenes
    rows = pp2.stage_rows(a_t, s_t, render_t.sampler_spec(s_t, "cpu"), runs=1)
    assert [r["name"].split(" (")[0].split(":")[0] for r in rows] == [
        "full pass", "path trace K1, sorted", "path trace K1, unsorted",
        "shadow trace K2, sorted", "argsort of the packet key", "permute", "permute",
        "primary intersect + prepare"]
    assert all(r["ms"] > 0 and r["device_ms"] is None for r in rows)
    assert rows[0]["rays"] > W * H
    assert capsys.readouterr().out.count("[cpu]") == len(rows) + 1


def test_attribution_on_cpu(scenes):
    """Every stage is named and gets its share; one cell per bounce; the
    named stages hold nearly all the operators' time."""
    _, (a_t, s_t) = scenes
    att = pp2.attribute(lambda: render_t.render(a_t, s_t, device="cpu"), "cpu")
    assert tuple(att["stages"]) == pp2.STAGES
    assert len(att["bounces"]) == s_t.max_depth
    for name in pp2.STAGES:
        cell = att["stages"][name]
        assert set(cell) == {"kernel_ms", "launches", "wall_ms", "host_ms"}
        assert cell["launches"] > 0 and 0 < cell["host_ms"] <= cell["wall_ms"], name
    assert att["named_share"] >= 0.95
    assert att["launches"] == sum(c["launches"] for c in att["stages"].values())
    assert att["syncs"]["count"] == 0 and att["unmatched_launches"] == 0
    assert att["texture_sites"] == {}  # no image texture in this scene
    assert att["device"] == "cpu"


@pytest.mark.parametrize("path, func, stage", [
    ("accel/cluster_trace.py", "trace", "trace kernels"),
    ("integrate/path_mis.py", "_packet_permute", "ordered permute"),
    ("integrate/path_mis.py", "_bounce_ordered", "shading"),
    ("integrate/path_mis.py", "_dmorton", None),
    ("shade/textures.py", "_bilinear_wh", "shading"),
    ("core/rng.py", "permute", "sampler draws"),
    ("samplers/streams.py", "index", None),
    ("film/film.py", "splat_grid", "splat"),
    ("core/math.py", "dot", None),
    ("integrate/camera.py", "sample_ray", "other"),
])
def test_frame_stage(path, func, stage):
    assert pp2.frame_stage(path, func) == stage


def test_texture_site():
    stack = ["kazen_tpu_torch/shade/textures.py(25): _bilinear_wh",
             "kazen_tpu_torch/shade/textures.py(142): eval_texture",
             "kazen_tpu_torch/shade/bsdf.py(365): _scalar_texture",
             "kazen_tpu_torch/integrate/path_mis.py(241): _bounce_ordered",
             "kazen_tpu_torch/integrate/path_mis.py(480): li_wavefront"]
    assert pp2._texture_site(stack) == ("textures.py:142 eval_texture <- bsdf.py:365 "
                                        "_scalar_texture <- path_mis.py:241 _bounce_ordered")
    assert pp2._texture_site(stack[2:]) is None


def test_stage_names_are_the_port_functions():
    """Every function name the attribution keys on is a function of the
    module it names, so a rename cannot move its time into another stage
    unseen."""
    from kazen_tpu_torch.integrate import path_mis
    from kazen_tpu_torch.samplers import streams

    for name in [*pp2.PATH_MIS_STAGES, pp2.BOUNCE, pp2.PROLOGUE]:
        assert callable(getattr(path_mis, name, None)), name
    assert callable(streams.StreamState.index)
    for path in pp2.SAMPLER_FILES:
        assert os.path.exists(os.path.join(os.path.dirname(pp2.__file__), "..", path)), path
