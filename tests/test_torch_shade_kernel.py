"""The bounce's shade stage (shade/bounce_kernel.py, path_mis._shade_plain):
the route each scene and call takes, the kernel's packed tables, the plain
version against the bounce body it was pulled out of, and (marked cuda) the
kernel against the plain version on the card. No JAX is needed here (only
the thread policy's helpers import it): the card's machine runs this file."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from kazen_tpu_torch.examples import baseline_configs as bc
from kazen_tpu_torch.integrate import path_mis
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.lab import shade_check
from kazen_tpu_torch.samplers import streams
from kazen_tpu_torch.scene import description as D
from kazen_tpu_torch.scene.compiler import BSDF_KISS, compile_scene
from kazen_tpu_torch.shade import bounce_kernel as bk
from kazen_tpu_torch.utils import metrics

import shade_host

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


def textured_con1(width, height, spp=1, seed=7, small=False):
    """The Textured scene of the benchmark's ``textured`` configuration
    (kzbench/scenes/textured.py: kazen-con-1's whole pipeline) at ``width``
    x ``height``; ``small`` cuts its sphere to 48x24 and its images to 32
    texels (and the sky to 64x32) for the CPU."""
    import json
    import os

    from kzbench.scenes import textured

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "kzbench", "configs", "textured.json")) as f:
        config = json.load(f)
    config.update(width=width, height=height, sample_count=spp, spp=spp, seed=seed)
    if small:
        config.update(sphere=dict(config["sphere"], nu=48, nv=24, image_size=32),
                      normal_map_size=32, sky=dict(config["sky"], height=32, width=64,
                                                   sun_rows=[8, 10], sun_cols=[20, 23]))
    return textured.build(D, config)


def _env_rough_con2(light=True):
    """con-2 at 48x27 with its image sky importance-sampled, its sphere a
    roughdielectric and a roughconductor and a roughplastic quad before the
    back wall; without ``light``, the environment is the only NEE
    stratum."""
    desc = con2(spp=1, size=(48, 27), importance=True)
    desc.meshes[-1].bsdf = D.RoughDielectric(roughness=0.3)
    desc.meshes += [bc.make_mesh([-0.9, 0.2, 0.8], [0, 0.5, 0], [0.5, 0, 0],
                                 bsdf=D.RoughConductor(material="Cu", alpha=0.4)),
                    bc.make_mesh([0.4, 0.2, 0.8], [0, 0.5, 0], [0.5, 0, 0],
                                 bsdf=D.RoughPlastic(alpha=0.3, kd=(0.2, 0.5, 0.7)))]
    if not light:
        desc.meshes = [m for m in desc.meshes if m.light is None]
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


def _scene_case(case):
    """con-2 with one change, by name."""
    if case == "textured field":
        return con2(base_color=_checker())
    if case == "normal map":
        desc = con2()
        desc.meshes[-1].bsdf = D.NormalMap(nested=desc.meshes[-1].bsdf, normals=_checker())
        return desc
    if case == "composite texture":
        return con2(base_color=D.ColorRamp(input=_checker(), min=0.2, max=0.8))
    if case == "env importance":
        return con2(importance=True)
    desc = con2()
    desc.meshes[-1].bsdf = {"roughconductor": D.RoughConductor, "roughplastic": D.RoughPlastic,
                            "roughdielectric": D.RoughDielectric}[case]()
    return desc


def _composite_sky():
    """con-2 with its background importance-sampled and a composite node
    (a colorramp) over its image."""
    desc = con2(importance=True)
    desc.background.texture = D.ColorRamp(input=desc.background.texture, min=0.1, max=0.9)
    return desc


@pytest.mark.parametrize("case, reason", [
    ("composite texture", "composite texture nodes with textured material fields"),
    ("composite sky", "composite texture nodes with env importance sampling"),
])
def test_scene_exclusions_take_the_plain_route(case, reason):
    desc = _composite_sky() if case == "composite sky" else _scene_case(case)
    arrays, static = compile_scene(desc, device="cpu", megakernel=False)
    assert bk.supported_reason(arrays, static) == (False, reason)
    assert bk.route_reason(arrays, static, (_Lane("cuda"),)) == ("plain", reason)
    assert arrays.shade_tables is None


@pytest.mark.parametrize("case", ["env importance", "roughconductor", "roughplastic",
                                  "roughdielectric", "textured con1"])
def test_rough_lobes_and_env_importance_take_the_kernel(case):
    """The Beckmann lobes and the importance-sampled environment are in the
    kernel's class: con-2 with each rough* material on its sphere or its
    sky importance-sampled, and the benchmark's Textured scene with all of
    them; their tables hold each material's alpha, eta and k and the
    environment's CDFs, pdf and background."""
    desc = textured_con1(8, 8) if case == "textured con1" else _scene_case(case)
    arrays, static = compile_scene(desc, device="cpu", megakernel=False)
    assert bk.supported_reason(arrays, static) == (True, "supported")
    assert bk.route_reason(arrays, static, (_Lane("cuda"),)) == ("kernel", "supported")
    tb, mt = arrays.shade_tables, arrays.materials
    assert torch.equal(tb.beck[:, 0], mt.alpha)
    assert torch.equal(tb.beck[:, 1:4], mt.eta_c) and torch.equal(tb.beck[:, 4:7], mt.k_c)
    assert torch.equal(tb.env_pdf, arrays.env_pdf) and torch.equal(tb.env_col, arrays.env_col_cdf)
    assert torch.equal(tb.env_row, arrays.env_row_cdf)
    assert torch.equal(tb.bg, torch.cat([arrays.bg_color, arrays.bg_intensity[None],
                                         arrays.bg_tex.float()[None], torch.zeros(3)]))
    assert bk.env_nee(static) == (case in ("env importance", "textured con1"))
    assert bk.rough_lobes(static) == (case != "env importance")


@pytest.mark.parametrize("case", ["textured field", "normal map", "config 3", "textured"])
def test_textured_and_normal_mapped_scenes_take_the_kernel(case):
    """Image-textured material fields and the normalmap wrapper are in the
    kernel's class: config 3 (an image base colour and a normal-mapped
    kiss), every texture field (textured_scene), and con-2 with either."""
    if case == "config 3":
        desc = bc.at_size(bc.config_scene(3, spp=1), *CON2_SIZE)
    elif case == "textured":
        desc = shade_check.textured_scene(*CON2_SIZE)
    else:
        desc = _scene_case(case)
    arrays, static = compile_scene(desc, device="cpu", megakernel=False)
    assert static.textured_fields and not static.has_composite_textures
    assert bk.supported_reason(arrays, static) == (True, "supported")
    assert bk.route_reason(arrays, static, (_Lane("cuda"),)) == ("kernel", "supported")
    assert arrays.shade_tables is not None


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


def test_packing_round_trips_to_the_texture_ids_and_nodes():
    """Config 3: each material's texture ids and nested row, and each
    texture node's type, offsets, size, levels, mip offsets, uv scale and
    constant, as the kernel reads them."""
    arrays, _ = compile_scene(bc.at_size(bc.config_scene(3, spp=1), *CON2_SIZE), device="cpu",
                              megakernel=False)
    tb, mt, tex = arrays.shade_tables, arrays.materials, arrays.textures
    for col, name in enumerate(("tex_base", "tex_metallic", "tex_roughness", "tex_normal",
                                "nested")):
        assert torch.equal(tb.mat_i[:, col].to(torch.int64), getattr(mt, name)), name
    assert (mt.nested >= 0).any() and (mt.tex_normal >= 0).any() and (mt.tex_base >= 0).any()
    for col, name in enumerate(("ttype", "offset", "width", "height", "n_levels")):
        assert torch.equal(tb.tex_i[:, col], getattr(tex, name)), name
    assert torch.equal(tb.tex_i[:, 5:], tex.mip_offset)
    assert torch.equal(tb.tex_f[:, 0], tex.uv_scale) and torch.equal(tb.tex_f[:, 1:],
                                                                      tex.const_color)
    assert tb.tex_i.shape[1] == bk.TEX_I and tb.mat_i.shape[1] == bk.MAT_I


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
    assert shade_check.lane_bytes(1, False) == shade_check.lane_bytes(1, True) - 4
    assert out["footprint_mode"] == bk.footprint_mode(static) == 0


# ---------------------------------------------------------------------------
# the kernel's source on the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    return shade_host.build(tmp_path_factory.mktemp("shade_host"))


class _Given:
    """The host library, keeping the footprint mode and pixel cone each
    launch's parameters give the kernel."""

    def __init__(self, lib):
        self.lib, self.given = lib, []

    def kz_shade_bounce(self, prm, stream):
        self.given.append((prm._obj.footprint, prm._obj.pixel_cone))
        return self.lib.kz_shade_bounce(prm, stream)

    def kz_error_string(self, code):
        return self.lib.kz_error_string(code)


@pytest.mark.parametrize("mip, aniso, mode", [(True, True, 2), (True, False, 1),
                                               (False, True, 0)])
def test_footprint_columns_follow_the_scene(mip, aniso, mode, host_library, monkeypatch):
    """The kernel derives the footprint the scene asks for and reads no
    footprint column: every launch is given mode 2 (lod and the major uv
    half-axis) with anisotropic mip filtering, 1 (lod) without anisotropy,
    0 without mip filtering, and the pixel cone rounded to f32; the tracer
    counts a ``kernel`` footprint a launch where the mode is not 0."""
    given = _Given(host_library)
    shade_host.kernel_on_host(monkeypatch, given)
    desc = shade_check.textured_scene(8, 8, mip=mip, aniso=aniso)
    arrays, static = compile_scene(desc, device="cpu", megakernel=False)
    assert bk.footprint_mode(static) == mode
    metrics.collect()
    with metrics.tracing():
        render_t.render(arrays, static, spp=1, device="cpu")
    got = metrics.collect()
    assert given.given == [(mode, float(np.float32(static.pixel_cone)))] * static.max_depth
    assert got["texture_footprint"] == ({"kernel": static.max_depth} if mode else {})
    assert "footprint" not in inspect.signature(bk.shade_cuda).parameters


def _helpers_textured(width, height):
    """The port tests' Textured box without composite nodes
    (tests/torch_port_helpers.py, which needs JAX for its description)."""
    helpers = pytest.importorskip("torch_port_helpers")
    return helpers.to_port(helpers.textured_scene(width, height, spp=1, composite=False))


HOST_CASES = {
    "con2": lambda: con2(spp=1, size=(48, 27)),
    "config3": lambda: bc.at_size(bc.config_scene(3, spp=1), 48, 27),
    "mixed": lambda: shade_check.mixed_scene(40, 40, sphere=True),
    **{name: (lambda kw=kw: shade_check.textured_scene(40, 40, **kw))
       for name, kw in shade_check.TEXTURED.items()},
    "textured_con1": lambda: textured_con1(40, 40, small=True),
    "textured_helpers": lambda: _helpers_textured(40, 40),
    "con2_env_rough": lambda: _env_rough_con2(),
    "con2_env_only": lambda: _env_rough_con2(light=False),
}


def _close_lanes(got, want):
    """Lanes of each ShadeOut column off by more than 1e-5 + 1e-3 |want|
    (NaN matching NaN)."""
    out = {}
    for name in shade_check.COLUMNS[:14]:
        a, b = (getattr(o, name).double().reshape(getattr(o, name).shape[0], -1)
                for o in (got, want))
        ok = torch.isclose(a, b, rtol=1e-3, atol=1e-5) | (torch.isnan(a) & torch.isnan(b))
        out[name] = int((~ok.all(1)).sum())
    return out


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_kernel_source_matches_plain_on_the_host(case, host_library, monkeypatch):
    """The kernel's body, built for the host and run through the wrapper and
    path_mis._shade's kernel route on CPU lanes, against _shade_plain on
    every bounce of a pass: every column within 1e-5 + 1e-3 |plain| on all
    but 1% of the lanes (the CPU's reduce orders and libm differ from the
    card's, which flips a lane near a threshold), every bounce on the
    kernel route, a textured field counted once a bounce."""
    shade_host.kernel_on_host(monkeypatch, host_library)
    arrays, static = compile_scene(HOST_CASES[case](), device="cpu", megakernel=False)
    off, routed = [], path_mis._shade

    def held(scene, st_, state, li, alive, draws):
        got = routed(scene, st_, state, li, alive, draws)
        off.append((_close_lanes(got, path_mis._shade_plain(scene, st_, state, li, alive,
                                                            draws)), got.p.shape[0]))
        return got

    monkeypatch.setattr(path_mis, "_shade", held)
    before = bk.SHADE.launches
    metrics.collect()
    with metrics.tracing():
        render_t.render(arrays, static, spp=1, device="cpu")
    got = metrics.collect()
    assert got["shade_route"] == {"kernel": static.max_depth}
    assert bk.SHADE.launches - before == static.max_depth == len(off)
    for field in static.textured_fields:
        assert got["texture_lookups"][field]["kernel"] == static.max_depth
    for bounce, (differ, n) in enumerate(off, 1):
        assert max(differ.values()) <= 0.01 * n, (bounce, differ)


def _degenerate_footprints(device="cpu"):
    """A scene and one ray a lane whose hits reach each degenerate branch
    of the texture footprint (path_mis._texture_footprint), on textured
    materials with anisotropic mip filtering: views along the normal of an
    image-textured kiss quad (material 0, which miss lanes read too), a
    1 cm lambertian quad whose uvs span 1e5 (a singular uv Jacobian, and
    |dpdu| under the 1e-6 clamp), a textured quad without vertex normals
    (uv_ok false: the fallback frame), a normal-mapped GGX quad, rays at
    the kiss quad from the camera and at a grazing angle (the 1/16 clamp of
    the cosine), and misses (t = 3e38, off the normal, so that their
    anisotropic branch runs on the clamped |t|)."""
    from kazen_tpu_torch.accel.intersect import Rays

    rs = np.random.default_rng(11)

    def image(n):
        return D.ImageTexture(data=rs.uniform(0.0, 1.0, (n, n, 3)).astype(np.float32),
                              colorspace="linear")

    def quad(corner, eu, ev, bsdf, normals=True, uv_span=1.0):
        v, f, n, uv = bc.quad(corner, eu, ev)
        return D.Mesh(vertices=v, faces=f, normals=n if normals else None,
                      uvs=(uv * uv_span).astype(np.float32), bsdf=bsdf)

    bump = np.full((16, 16, 3), (0.5, 0.5, 1.0), np.float32)
    bump[..., :2] += rs.uniform(-0.3, 0.3, (16, 16, 2)).astype(np.float32)
    desc = bc.cornell_box(width=16, height=16, spp=1, regularization=True)
    light = desc.meshes[5]
    desc.meshes = [
        quad([-0.8, 0.2, 0.6], [0, 0.6, 0], [0.6, 0, 0], D.KazenStandard(
            base_color=image(32), metallic=image(8), roughness=image(16), clearcoat=0.5)),
        quad([0.3, 0.3, 0.5], [0, 0.01, 0], [0.01, 0, 0], D.Lambertian(albedo=image(8)),
             uv_span=1e5),
        quad([0.2, 1.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], D.Lambertian(albedo=image(16)),
             normals=False),
        quad([-0.8, 1.0, 0.6], [0, 0.6, 0], [0.6, 0, 0], D.NormalMap(
            nested=D.GGX(albedo=image(8), roughness=0.3),
            normals=D.ImageTexture(data=bump, colorspace="linear"))),
        light,
    ]
    desc.mip_textures = desc.aniso_textures = True
    arrays, static = compile_scene(desc, device=device, megakernel=False)

    k = 32
    eye = torch.tensor([0.0, 1.0, -2.5])

    def at(lo, hi, z):
        xy = torch.from_numpy(rs.uniform(lo, hi, (k, 2)).astype(np.float32))
        return torch.cat([xy, torch.full((k, 1), z)], 1)

    along = at(-0.75, -0.25, -1.0)
    along[:, 1] += 1.0
    targets = torch.cat([at(-0.75, -0.25, 0.6), at(0.301, 0.309, 0.5), at(0.25, 0.75, 0.6),
                         at(-0.75, -0.25, 0.6)])
    targets[:k, 1] += 1.0
    targets[2 * k:3 * k, 1] += 0.75
    targets[3 * k:, 1] += 1.75
    graze = at(0.25, 0.75, 0.55)
    graze[:, 0] = -1.5
    o = torch.cat([along, eye.expand(4 * k, 3), graze, at(-0.5, 0.5, -1.0)])
    d = torch.cat([torch.tensor([0.0, 0.0, 1.0]).expand(k, 3),
                   torch.nn.functional.normalize(targets - eye, dim=1),
                   torch.nn.functional.normalize(torch.tensor([[1.0, 0.0, 0.05]]), dim=1)
                   .expand(k, 3),
                   torch.nn.functional.normalize(torch.tensor([[0.3, 0.2, -1.0]]), dim=1)
                   .expand(k, 3)])
    n = o.shape[0]
    rays = Rays(o=o.contiguous().to(device), d=d.contiguous().to(device),
                mint=torch.full((n,), path_mis.EPSILON, device=device),
                maxt=torch.full((n,), path_mis.INF, device=device))
    return arrays, static, rays


def _first_bounce_state(arrays, static, rays):
    """The sampler spec and the wavefront state of the rays' first bounce
    (a lane a pixel in row-major order)."""
    from kazen_tpu_torch.core import rng

    dev = rays.o.device
    spec = render_t.sampler_spec(static, dev)
    lanes = torch.arange(rays.o.shape[0], device=dev)
    stream = streams.init_stream_jump(spec, lanes % static.width, lanes // static.width, 0,
                                      rng.advance_constants(0))
    return spec, path_mis.wavefront_init(arrays, static, spec, stream, rays)


def _footprint_branches(st):
    """Per lane: a miss (t = 3e38), a view along the normal, a grazing view
    (|cos| under 1/16), a singular uv Jacobian, uv_ok false: the conditions
    _texture_footprint and _prepare_core branch on."""
    from kazen_tpu_torch.core import math as km

    its = path_mis._hit_interaction(st)
    nrm = its.sh_frame.n
    dn = (st.ray_d * nrm).sum(-1)
    tl = km.norm(st.ray_d - dn[:, None] * nrm)
    e, fg, g = ((a * b).sum(-1) for a, b in ((its.dpdu, its.dpdu), (its.dpdu, its.dpdv),
                                              (its.dpdv, its.dpdv)))
    hit = its.valid
    return {"miss": ~hit & (its.t == path_mis.INF), "along the normal": hit & (tl <= 1e-5),
            "grazing": hit & (dn.abs() < 1.0 / 16.0),
            "singular uv Jacobian": hit & (e * g - fg * fg <= 1e-16),
            "uv_ok false": hit & (st.rows[31] <= 0.0)}


def test_kernel_footprint_branches_match_plain_on_the_host(host_library, monkeypatch):
    """The kernel's in-kernel footprint on hits that reach each of its
    degenerate branches, on every bounce of the lanes of
    _degenerate_footprints: every column within the host test's tolerance
    of _shade_plain (1e-5 + 1e-3 |plain| on all but 1% of the lanes); on
    the first bounce each branch holds on 32 lanes or more, and the miss
    lanes read material 0, an image-textured kiss."""
    shade_host.kernel_on_host(monkeypatch, host_library)
    arrays, static, rays = _degenerate_footprints()
    assert bk.footprint_mode(static) == 2
    n = rays.o.shape[0]
    spec, st = _first_bounce_state(arrays, static, rays)
    branches = _footprint_branches(st)
    for name, lanes_ in branches.items():
        assert int(lanes_.sum()) >= 32, (name, int(lanes_.sum()))
    assert (st.rows[30][branches["miss"]] == 0).all()
    assert int(arrays.materials.btype[0]) == BSDF_KISS and int(arrays.materials.tex_base[0]) >= 0
    off, routed = [], path_mis._shade

    def held(scene, st_, state, li, alive, draws):
        got = routed(scene, st_, state, li, alive, draws)
        off.append(_close_lanes(got, path_mis._shade_plain(scene, st_, state, li, alive, draws)))
        return got

    monkeypatch.setattr(path_mis, "_shade", held)
    metrics.collect()
    with metrics.tracing():
        for depth in range(static.max_depth):
            st = path_mis._bounce_ordered(arrays, static, spec, st, depth >= 3)
    got = metrics.collect()
    assert got["shade_route"] == {"kernel": static.max_depth}
    assert got["texture_footprint"] == {"kernel": static.max_depth}
    for bounce, differ in enumerate(off, 1):
        assert max(differ.values()) <= 0.01 * n, (bounce, differ)


ZERO_ROW = 128  # the environment row whose texels' pdf _rough_env_branches zeroes


def _rough_env_branches(device="cpu"):
    """The Textured scene (its sphere and images cut for the CPU) and one
    ray a lane, 32 lanes a group, whose hits reach the rough* lobes' and the
    environment sample's edge branches: camera rays at the roughconductor,
    roughplastic and roughdielectric quads, rays at each quad's back (wi
    below the horizon; the dielectric from inside), grazing rays at the
    conductor (sampled wo below the horizon) and at the dielectric from
    inside (total internal reflection). The environment's row ZERO_ROW has
    its texels' pdf set to 0."""
    from kazen_tpu_torch.accel.intersect import Rays

    arrays, static = compile_scene(textured_con1(16, 16, small=True), device=device,
                                   megakernel=False)
    pdf = arrays.env_pdf.clone()
    pdf[ZERO_ROW] = 0.0
    arrays = dataclasses.replace(arrays, env_pdf=pdf)
    rs = np.random.default_rng(5)
    k = 32

    def on(x, y, z):
        pts = np.stack([rs.uniform(*x, k), rs.uniform(*y, k), np.full(k, z)], 1)
        return torch.from_numpy(pts.astype(np.float32))

    def unit(v):
        return torch.nn.functional.normalize(torch.tensor([v], dtype=torch.float32), dim=1)

    eye = torch.tensor([0.0, 1.0, -2.5])
    cond, plas, diel = ((-0.9, -0.5), (1.3, 1.7), 0.9), ((0.5, 0.9), (1.3, 1.7), 0.9), \
        ((-0.25, 0.25), (0.1, 0.4), -0.5)
    fronts = torch.cat([on(*cond), on(*plas), on(*diel)])
    back = torch.cat([on(*cond[:2], 0.95), on(*plas[:2], 0.95), on(*diel[:2], -0.3)])
    graze_c, graze_d = unit([0.0, -1.0, 0.08]), unit([0.0, -1.0, -0.1])
    o = torch.cat([eye.expand(3 * k, 3), back, on(*cond) - 0.3 * graze_c,
                   on(*diel) - 0.3 * graze_d])
    d = torch.cat([torch.nn.functional.normalize(fronts - eye, dim=1),
                   torch.tensor([0.0, 0.0, -1.0]).expand(3 * k, 3), graze_c.expand(k, 3),
                   graze_d.expand(k, 3)])
    n = o.shape[0]
    rays = Rays(o=o.contiguous().to(device), d=d.contiguous().to(device),
                mint=torch.full((n,), path_mis.EPSILON, device=device),
                maxt=torch.full((n,), path_mis.INF, device=device))
    return arrays, static, rays


def _edge_draws(arrays, monkeypatch):
    """path_mis._bounce_draws with every other lane's light pick on the
    environment (the last of 2 strata) and, on a quarter of the lanes each,
    its row draw at 0, at 1 - 2^-24 (its column draw too) and at the start
    of ZERO_ROW (the streams advance as they did)."""
    orig = path_mis._bounce_draws
    start = float(arrays.env_row_cdf[ZERO_ROW])
    top = float(np.float32(1.0 - 2.0 ** -24))

    def edges(spec, static, stream, draw_rr):
        stream, dr = orig(spec, static, stream, draw_rr)
        lane = torch.arange(dr.s1.shape[0], device=dr.s1.device) % 8
        u_a = torch.where(lane == 0, 0.0, torch.where(lane == 2, top, torch.where(
            lane == 4, start, dr.u_a)))
        u_b = torch.where(lane == 2, top, torch.where(lane == 6, 0.0, dr.u_b))
        u_pick = torch.where(lane % 2 == 0, 0.75, dr.u_pick)
        return stream, dr._replace(u_pick=u_pick, u_a=u_a, u_b=u_b)

    monkeypatch.setattr(path_mis, "_bounce_draws", edges)
    return edges


def _rough_env_lanes(arrays, static, spec, st, draws):
    """Per lane, on the first bounce: the environment picked with its row
    draw at 0, at 1 - 2^-24 and on the zero-pdf row; a rough* lane with wi
    below the horizon, a conductor's sampled wo below the horizon (its
    half-vector then +z in the eval), a roughdielectric sample in total
    internal reflection, and one that refracts."""
    from kazen_tpu_torch.core import math as km
    from kazen_tpu_torch.core import warp
    from kazen_tpu_torch.scene.compiler import (BSDF_ROUGHCONDUCTOR, BSDF_ROUGHDIELECTRIC,
                                                BSDF_ROUGHPLASTIC)
    from kazen_tpu_torch.shade import lights

    its = path_mis._hit_interaction(st)
    hit = its.valid
    wi = its.sh_frame.to_local(-st.ray_d)
    mp = arrays.materials.rows(its.material)
    env = hit & (draws.u_pick >= 0.5)
    pdf = lights.sample_env_light(arrays, static, draws.u_a, draws.u_b).pdf
    rough = hit & ((mp.btype == BSDF_ROUGHCONDUCTOR) | (mp.btype == BSDF_ROUGHPLASTIC)
                   | (mp.btype == BSDF_ROUGHDIELECTRIC))
    wo = km.normalize(km.reflect(wi, warp.square_to_beckmann(draws.s2, mp.alpha)))
    diel = hit & (mp.btype == BSDF_ROUGHDIELECTRIC)
    alpha = mp.alpha * (1.2 - 0.2 * torch.sqrt(torch.abs(wi[:, 2])))
    wm = warp.square_to_beckmann(draws.s2, alpha)
    _, cos_t = km.fresnel_dielectric(km.dot(wi, wm), mp.int_ior / mp.ext_ior)
    return {"env row draw 0": env & (draws.u_a == 0.0),
            "env row draw 1 - 2^-24": env & (draws.u_a > 0.99),
            "env zero-pdf row": env & (pdf == 0.0),
            "rough wi below the horizon": rough & (wi[:, 2] < 0.0),
            "conductor wo below the horizon": hit & (mp.btype == BSDF_ROUGHCONDUCTOR)
            & (wi[:, 2] > 0.0) & (wo[:, 2] <= 0.0),
            "dielectric total internal reflection": diel & (cos_t == 0.0),
            "dielectric refraction": diel & (cos_t != 0.0)}


def test_kernel_rough_and_env_branches_match_plain_on_the_host(host_library, monkeypatch):
    """The kernel's rough* lobes and environment sample on lanes that reach
    their edge branches (_rough_env_branches, _edge_draws), on every bounce:
    every column within the host test's tolerance of _shade_plain (1e-5 +
    1e-3 |plain| on all but 1% of the lanes); on the first bounce each
    branch holds on 4 lanes or more."""
    shade_host.kernel_on_host(monkeypatch, host_library)
    arrays, static, rays = _rough_env_branches()
    assert bk.env_nee(static) and static.num_lights == 1
    edges = _edge_draws(arrays, monkeypatch)
    spec, st = _first_bounce_state(arrays, static, rays)
    for name, lanes_ in _rough_env_lanes(arrays, static, spec, st,
                                         edges(spec, static, st.stream, False)[1]).items():
        assert int(lanes_.sum()) >= 4, (name, int(lanes_.sum()))
    off, routed = [], path_mis._shade

    def held(scene, st_, state, li, alive, draws):
        got = routed(scene, st_, state, li, alive, draws)
        off.append(_close_lanes(got, path_mis._shade_plain(scene, st_, state, li, alive, draws)))
        return got

    monkeypatch.setattr(path_mis, "_shade", held)
    metrics.collect()
    with metrics.tracing():
        for depth in range(static.max_depth):
            st = path_mis._bounce_ordered(arrays, static, spec, st, depth >= 3)
    got = metrics.collect()
    assert got["shade_route"] == {"kernel": static.max_depth}
    assert got["env_nee"] == got["beckmann_lobes"] == {"kernel": static.max_depth}
    n = rays.o.shape[0]
    for bounce, differ in enumerate(off, 1):
        assert max(differ.values()) <= 0.01 * n, (bounce, differ)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


CARD_CASES = {
    "con2_1080p": lambda: bc.config_scene(4, spp=1),
    "config2_256": lambda: bc.config_scene(2, spp=1),
    "mixed_multi": lambda: shade_check.mixed_scene(256, 256, sphere=True),
    "mixed_single": lambda: shade_check.mixed_scene(128, 128, sphere=False),
    "config3_512": lambda: bc.config_scene(3, spp=1),
    "config3_2160p": lambda: bc.at_size(bc.config_scene(3, spp=1), 3840, 2160),
    **{name: (lambda kw=kw: shade_check.textured_scene(256, 256, **kw))
       for name, kw in shade_check.TEXTURED.items()},
    "textured_con1_2160p": lambda: textured_con1(3840, 2160),
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


@pytest.mark.cuda
def test_kernel_rough_and_env_branches_match_plain_on_card(monkeypatch):
    """The rough* lobes' and the environment sample's edge branches on the
    lanes of _rough_env_branches with _edge_draws: every column of every
    bounce equal bit for bit to _shade_plain's, every bounce on the
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the shade kernel has no CPU mode")
    arrays, static, rays = _rough_env_branches("cuda")
    edges = _edge_draws(arrays, monkeypatch)
    spec, st = _first_bounce_state(arrays, static, rays)
    lanes = _rough_env_lanes(arrays, static, spec, st, edges(spec, static, st.stream, False)[1])
    assert all(int(m.sum()) >= 4 for m in lanes.values()), {
        k: int(m.sum()) for k, m in lanes.items()}
    records = []
    with shade_check.held(records):
        for depth in range(static.max_depth):
            st = path_mis._bounce_ordered(arrays, static, spec, st, depth >= 3)
    assert [r["route"] for r in records] == ["kernel"] * static.max_depth
    for r in records:
        assert not any(r["differ"].values()), (r["bounce"], r["differ"])


@pytest.mark.cuda
def test_kernel_footprint_branches_match_plain_on_card():
    """The in-kernel footprint on the lanes of _degenerate_footprints,
    which reach each of its degenerate branches: every column of every
    bounce equal bit for bit to _shade_plain's, every bounce on the
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the shade kernel has no CPU mode")
    arrays, static, rays = _degenerate_footprints("cuda")
    spec, st = _first_bounce_state(arrays, static, rays)
    assert all(int(m.sum()) >= 32 for m in _footprint_branches(st).values())
    records = []
    with shade_check.held(records):
        for depth in range(static.max_depth):
            st = path_mis._bounce_ordered(arrays, static, spec, st, depth >= 3)
    assert [r["route"] for r in records] == ["kernel"] * static.max_depth
    for r in records:
        assert not any(r["differ"].values()), (r["bounce"], r["differ"])
