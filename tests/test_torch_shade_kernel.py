"""The bounce's shade stage (shade/bounce_kernel.py, path_mis._shade_plain):
the route each scene and call takes, the kernel's packed tables, the plain
version against the bounce body it was pulled out of, and (marked cuda) the
kernel against the plain version on the card. No JAX is needed here (only
the thread policy's helpers import it): the card's machine runs this file."""
import dataclasses

import numpy as np
import pytest
import torch

from kazen_tpu_torch.examples import baseline_configs as bc
from kazen_tpu_torch.integrate import path_mis
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.lab import shade_check
from kazen_tpu_torch.samplers import streams
from kazen_tpu_torch.scene import description as D
from kazen_tpu_torch.scene.compiler import compile_scene
from kazen_tpu_torch.shade import bounce_kernel as bk

try:  # the port's tests' torch-thread policy; the card's machine has no JAX
    import torch_port_helpers  # noqa: F401
except ModuleNotFoundError as e:
    if e.name != "jax":
        raise

CON2_SIZE = (64, 36)


def con2(spp=2, size=CON2_SIZE, **changes):
    """BASELINE config 4 (con-2) at ``size``; ``changes`` edit its sphere's
    kiss material or its background."""
    desc = bc.at_size(bc.config_scene(4, spp=spp), *size)
    sphere = desc.meshes[-1]
    for key, value in changes.items():
        if key == "importance":
            desc.background.importance = value
        else:
            sphere.bsdf = dataclasses.replace(sphere.bsdf, **{key: value})
    return desc


@pytest.fixture(scope="module")
def con2_scene():
    return compile_scene(con2(), device="cpu", megakernel=False)


class _Lane:
    """Stands in for a lane tensor: its device and whether it needs grad."""

    def __init__(self, device, requires_grad=False):
        self.device = torch.device(device)
        self.requires_grad = requires_grad


def test_con2_takes_the_kernel(con2_scene):
    arrays, static = con2_scene
    assert bk.supported_reason(arrays, static) == (True, "supported")
    assert arrays.shade_tables is not None
    assert bk.route_reason(arrays, static, (_Lane("cuda"),)) == ("kernel", "supported")


def _checker():
    img = np.zeros((8, 8, 3), np.float32)
    img[::2] = 1.0
    return D.ImageTexture(data=img, colorspace="linear")


@pytest.mark.parametrize("case, reason", [
    ("textured field", "textured material field base"),
    ("normal map", "normal map present"),
    ("env importance", "env importance sampling enabled"),
    ("lobe outside the set", "BSDF type outside the kernel's set"),
])
def test_scene_exclusions_take_the_plain_route(case, reason):
    if case == "textured field":
        desc = con2(base_color=_checker())
    elif case == "normal map":
        desc = con2()
        desc.meshes[-1].bsdf = D.NormalMap(nested=desc.meshes[-1].bsdf, normals=_checker())
    elif case == "env importance":
        desc = con2(importance=True)
    else:
        desc = con2()
        desc.meshes[-1].bsdf = D.RoughConductor()
    arrays, static = compile_scene(desc, device="cpu", megakernel=False)
    assert bk.supported_reason(arrays, static) == (False, reason)
    assert bk.route_reason(arrays, static, (_Lane("cuda"),)) == ("plain", reason)
    assert arrays.shade_tables is None


@pytest.mark.parametrize("case, reason", [
    ("autograd call", "autograd call"),
    ("CPU tensors", "CPU tensors"),
])
def test_call_exclusions_take_the_plain_route(case, reason, con2_scene):
    arrays, static = con2_scene
    if case == "autograd call":
        rough = arrays.materials.roughness.clone().requires_grad_(True)
        swapped = dataclasses.replace(
            arrays, materials=dataclasses.replace(arrays.materials, roughness=rough))
        assert bk.route_reason(swapped, static, (_Lane("cuda"),)) == ("plain", reason)
        with torch.no_grad():
            assert bk.route_reason(swapped, static, (_Lane("cuda"),))[0] == "kernel"
        assert bk.route_reason(arrays, static, (_Lane("cuda", True),)) == ("plain", reason)
    else:
        assert bk.route_reason(arrays, static, (torch.zeros(2, 3),)) == ("plain", reason)


def test_packing_round_trips_to_the_material_rows(con2_scene):
    arrays, _ = con2_scene
    tb = arrays.shade_tables
    mt = arrays.materials
    idx = torch.arange(mt.btype.shape[0])
    rows = mt.rows(idx)
    assert torch.equal(tb.mats[:, 0].to(torch.int64), rows.btype)
    assert torch.equal(tb.mats[:, 1:4], rows.base_color)
    for col, name in enumerate(bk.MAT_FIELDS, start=4):
        assert torch.equal(tb.mats[:, col], getattr(rows, name)), name
    lf = arrays.light_faces
    assert torch.equal(tb.ltris, arrays.face_shade[lf.reshape(-1)][:, :bk.LTRI_F])
    assert torch.equal(tb.linfo[:, 0:3], arrays.light_radiance)
    assert torch.equal(tb.linfo[:, 3], arrays.light_inv_area)
    assert torch.equal(tb.linfo[:, 4] > 0, arrays.mesh_has_normals[arrays.light_mesh])
    assert torch.equal(tb.lcdf, arrays.light_cdf)
    assert tb.maxlf == lf.shape[1]


def test_tables_follow_a_swapped_or_edited_parameter(con2_scene):
    arrays, _ = con2_scene
    assert bk.tables_for(arrays) is arrays.shade_tables
    rough = arrays.materials.roughness.clone()
    rough[-1] = 0.5
    swapped = dataclasses.replace(
        arrays, materials=dataclasses.replace(arrays.materials, roughness=rough))
    tb = bk.tables_for(swapped)
    assert tb is not arrays.shade_tables and float(tb.mats[-1, 5]) == 0.5
    assert bk.tables_for(swapped) is not swapped.shade_tables
    packed = dataclasses.replace(swapped, shade_tables=tb)
    assert bk.tables_for(packed) is tb
    rough[-1] = 0.25  # in place: the version counter moves
    assert float(bk.tables_for(packed).mats[-1, 5]) == 0.25


# ---------------------------------------------------------------------------
# the plain version against the bounce body it was pulled out of
# ---------------------------------------------------------------------------


def _old_bounce_ordered(scene, static, spec, st, draw_rr):
    """A frozen copy of _bounce_ordered's body as it was before the shade
    stage left it for _shade_plain: each draw at its stage."""
    from kazen_tpu_torch.accel.intersect import Rays
    from kazen_tpu_torch.shade import bsdf as bsdf_mod
    from kazen_tpu_torch.shade import lights as lights_mod
    from kazen_tpu_torch.shade.interaction import prepare_from_rows

    pm = path_mis
    n = st.ray_o.shape[0]
    dev = st.ray_o.device
    stream = st.stream
    li, alive = pm._shade_prologue(scene, static, st)
    its = prepare_from_rows(
        Rays(o=st.ray_o, d=st.ray_d, mint=torch.zeros(n, device=dev),
             maxt=torch.full((n,), pm.INF, device=dev)), st.rows)[1]
    throughput, eta, accum = st.throughput, st.eta, st.accum_rough
    wi_local = its.sh_frame.to_local(-st.ray_d)
    lod, aniso = pm._texture_footprint(static, its, st.ray_d)
    ctx = bsdf_mod.make_ctx(static, scene, its.material, its.uv, its.sh_frame, wi_local,
                            dpdu=its.dpdu, lod=lod, aniso=aniso)
    hit_light = alive & (its.light >= 0)
    bw = torch.where(st.discrete, 1.0,
                     pm.power_heuristic(st.bsdf_pdf, pm._light_pdf_at_hit(scene, its, st.ray_o)))
    le = pm._light_eval_at_hit(scene, its, st.ray_o)
    li = li + torch.where(hit_light[:, None], bw[:, None] * throughput * le, 0.0)
    alive = alive & ~hit_light
    if draw_rr:
        stream, u_rr = streams.next_1d(spec, stream)
        prob = torch.clamp(throughput.amax(dim=-1) * eta * eta, max=0.95)
        alive = alive & ~(prob <= u_rr)
        rr_scale = torch.where(alive, 1.0 / torch.clamp(prob, min=1e-9), 1.0)
        throughput = throughput * rr_scale[:, None]
    n_strat = static.num_lights
    stream, u_pick = streams.next_1d(spec, stream)
    stream, u_tri = streams.next_1d(spec, stream)
    stream, u_a = streams.next_1d(spec, stream)
    stream, u_b = streams.next_1d(spec, stream)
    pick = lights_mod.select_uniform(n_strat, u_pick)
    ls = lights_mod.sample_area_light(
        scene, torch.clamp(pick, 0, static.num_lights - 1), its.p, u_tri, u_a, u_b)
    nee_wi, nee_maxt = ls.wi, ls.dist - static.trace_bias
    wo_local = its.sh_frame.to_local(nee_wi)
    f, pdf_b = bsdf_mod.eval_pdf_ctx(static, ctx, wo_local, accum)
    w_light = pm.power_heuristic(ls.pdf, pdf_b)
    contrib = torch.where(alive[:, None], throughput * (ls.ls * n_strat) * f * w_light[:, None],
                          0.0)
    shadow = alive & (contrib != 0.0).any(dim=-1)
    smaxt = torch.where(shadow, nee_maxt, -1.0)
    n_shadow_rays = shadow.sum(dtype=torch.float32)
    if static.regularization:
        reg = bsdf_mod.regularize_ctx(static, ctx)
        accum = torch.where(alive, accum + reg * static.accumulated_roughness, accum)
    stream, s1 = streams.next_1d(spec, stream)
    stream, s2 = streams.next_2d(spec, stream)
    res = bsdf_mod.sample_ctx(static, ctx, s1, s2, accum)
    throughput = torch.where(alive[:, None], throughput * res.weight, throughput)
    eta = torch.where(alive, eta * res.eta, eta)
    alive = alive & (res.weight > 0.0).any(dim=-1)
    pd = its.sh_frame.to_world(res.wo)
    n_path_rays = alive.sum(dtype=torch.float32)
    key = pm.packet_key(pick, its.cluster, pd, alive, smaxt)
    fl, stream, lane = pm._packet_permute(
        key,
        [its.p, nee_wi, smaxt[:, None], pd, li, throughput, eta[:, None], accum[:, None],
         contrib, res.pdf[:, None], res.is_discrete[:, None].to(torch.float32),
         alive[:, None].to(torch.float32)],
        stream, st.lane)
    p, nee_wi, smaxt, pd = fl[:, 0:3], fl[:, 3:6], fl[:, 6], fl[:, 7:10]
    li, throughput, eta, accum = fl[:, 10:13], fl[:, 13:16], fl[:, 16], fl[:, 17]
    contrib, bsdf_pdf = fl[:, 18:21], fl[:, 21]
    discrete, alive = fl[:, 22] > 0.5, fl[:, 23] > 0.5
    occluded = pm._occluded(scene, p, nee_wi, static.trace_bias, smaxt, smaxt >= 0.0)
    li = li + torch.where(occluded[:, None], 0.0, contrib)
    rays = Rays(o=p, d=pd, mint=torch.full((n,), static.trace_bias, device=dev),
                maxt=torch.where(alive, pm.INF, -1.0))
    return pm._OState(
        stream=stream, ray_o=p, ray_d=pd, rows=pm._trace_rows(scene, rays), li=li,
        throughput=throughput, eta=eta, bsdf_pdf=bsdf_pdf, discrete=discrete,
        accum_rough=accum, alive=alive, lane=lane,
        rays=st.rays + n_shadow_rays + n_path_rays)


def _same_state(a, b, label):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        for u, v in zip(x if name == "stream" else (x,), y if name == "stream" else (y,)):
            assert u.dtype == v.dtype and u.shape == v.shape, (label, name)
            bits = (lambda t: t.view(torch.int32)) if u.dtype == torch.float32 else (lambda t: t)
            assert torch.equal(bits(u.contiguous()), bits(v.contiguous())), (label, name)


def test_plain_gives_the_old_bounces_bit_for_bit(con2_scene, monkeypatch):
    """con-2 at 64x36, 2 spp: every bounce's state, drawn at the head now,
    equals the old body's, and so does the image."""
    arrays, static = con2_scene
    assert path_mis._nee_strata(static) == static.num_lights > 0
    assert static.regularization and arrays.trace_tables.num_clusters > 1
    spec = render_t.sampler_spec(static, "cpu")
    px, py = render_t.pixel_grid(static, arrays.device)
    from kazen_tpu_torch.core import rng

    for s in range(2):
        stream = streams.init_stream_jump(spec, px, py, s, rng.advance_constants(s * 65536))
        stream, jitter = streams.next_pixel_2d(spec, stream)
        stream, aperture = streams.next_2d(spec, stream)
        rays = render_t.camera_mod.sample_ray(
            arrays, static, torch.stack([px, py], -1).to(torch.float32) + jitter, aperture)
        st = path_mis.wavefront_init(arrays, static, spec, stream, rays)
        for depth in range(static.max_depth):
            new = path_mis._bounce_ordered(arrays, static, spec, st, depth >= 3)
            old = _old_bounce_ordered(arrays, static, spec, st, depth >= 3)
            _same_state(new, old, f"pass {s} bounce {depth + 1}")
            st = new
    img = render_t.render(arrays, static, device="cpu")
    monkeypatch.setattr(path_mis, "_bounce_ordered", _old_bounce_ordered)
    assert torch.equal(img, render_t.render(arrays, static, device="cpu"))


def test_shade_check_rehearses_on_the_cpu(con2_scene):
    """lab/shade_check on the CPU: the route is the plain version, held
    against itself, every column equal; the bound counts a lane's bytes."""
    arrays, static = con2_scene
    res = shade_check.check_pass(arrays, static)
    out = shade_check.summary(res)
    assert out["equal"] and out["bounces"] == static.max_depth
    assert out["shade_route"] == {"plain": static.max_depth} and out["kernel_launches"] == 0
    assert {r["reason"] for r in res["bounces"]} == {"CPU tensors"}
    assert shade_check.lane_bytes(1, True) == 4 * (31 + 12 + 3 + 8) + 2 + 4 * 24 + 16


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


CARD_CASES = {
    "con2_1080p": lambda: bc.config_scene(4, spp=1),
    "config2_256": lambda: bc.config_scene(2, spp=1),
    "mixed_multi": lambda: shade_check.mixed_scene(256, 256, sphere=True),
    "mixed_single": lambda: shade_check.mixed_scene(128, 128, sphere=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_on_card(case):
    """The kernel against the plain version on every bounce of a pass:
    every column equal bit for bit; the main path launched the kernel on
    all of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the shade kernel has no CPU mode")
    arrays, static = compile_scene(CARD_CASES[case](), device="cuda", megakernel=False)
    out = shade_check.summary(shade_check.check_pass(arrays, static))
    assert out["equal"], out["differ"]
    assert out["shade_route"] == {"kernel": static.max_depth}
    assert out["kernel_launches"] == static.max_depth
