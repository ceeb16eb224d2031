"""kazen_tpu_torch's textures, environment light and discrete pdf against
kazen_tpu's on the CPU, and a textured, environment-lit pmj02bn scene end
to end.

- The compiler's texture pool and material table equal the reference's
  array for array. The environment tables hold to rtol 1e-5 / atol 1e-6:
  both compilers rasterize the sky through their framework's atan2 and
  asin, which differ in the last bit on some texels, and the prefix sums
  carry that bit along the rows.
- eval_texture (image, composite, mip levels, EWA probes), the lat-long
  lookup, the environment sampler, its pdf, the background, the texture
  footprint, the scatter splat and dpdf hold to test_torch_shade.py's
  rtol 1e-5 / atol 1e-6, on the reference's tables carried across.
- li_wavefront on the textured scene, and the port's lane-chunked render()
  against its full-grid render(), hold to test_torch_render.py's limits:
  rtol 1e-3 / atol 1e-4 on >= 99% of lanes, channel means within 0.5%,
  rays within 0.1%.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.accel import cluster_trace as ct_j
from kazen_tpu.accel.intersect import Rays as RaysJ
from kazen_tpu.core import dpdf as dpdf_j
from kazen_tpu.film import film as film_j
from kazen_tpu.integrate import camera as cam_j
from kazen_tpu.integrate import path_mis as pm_j
from kazen_tpu.integrate import render as render_j
from kazen_tpu.samplers import streams as streams_j
from kazen_tpu.shade import interaction as inter_j
from kazen_tpu.shade import lights as lights_j
from kazen_tpu.shade import textures as tex_j
from kazen_tpu_torch.accel.intersect import Rays as RaysT
from kazen_tpu_torch.core import dpdf as dpdf_t
from kazen_tpu_torch.film import film as film_t
from kazen_tpu_torch.integrate import camera as cam_t
from kazen_tpu_torch.integrate import path_mis as pm_t
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.samplers import streams as streams_t
from kazen_tpu_torch.shade import interaction as inter_t
from kazen_tpu_torch.shade import lights as lights_t
from kazen_tpu_torch.shade import textures as tex_t

from kazen_tpu_torch.diff import inverse
from kazen_tpu_torch.examples import baseline_configs as bc
from kazen_tpu_torch.scene.compiler import compile_scene

from torch_port_helpers import (
    assert_static_equal,
    base_textured_scene,
    compile_port,
    compile_reference,
    port_from_reference,
    textured_scene,
)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def textured():
    """(description, the reference's compile, the port's compile, the
    reference's compile carried across to the port)."""
    desc = textured_scene()
    a_j, s_j = compile_reference(desc)
    return desc, (a_j, s_j), compile_port(desc), port_from_reference(a_j, s_j)


def close(got, want, err=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=err, **TOL)


def test_compiled_tables_equal(textured):
    _, (a_j, s_j), (a_t, s_t), _ = textured
    assert s_t.has_image_textures and s_t.has_composite_textures and s_t.env_importance
    assert s_t.mip_textures and s_t.aniso_textures and s_t.sampler_kind == "pmj02bn"
    assert s_t.textured_fields == ("base", "metallic", "roughness", "normal")
    assert_static_equal(s_t, s_j, a_j)
    for f in dataclasses.fields(a_t.textures):
        np.testing.assert_array_equal(
            getattr(a_t.textures, f.name).numpy(), np.asarray(getattr(a_j.textures, f.name)),
            err_msg=f.name,
        )
    for f in dataclasses.fields(a_t.materials):
        np.testing.assert_array_equal(
            getattr(a_t.materials, f.name).numpy(), np.asarray(getattr(a_j.materials, f.name)),
            err_msg=f.name,
        )
    for name in ("bg_tex", "bg_color", "bg_intensity", "mesh_material"):
        np.testing.assert_array_equal(
            getattr(a_t, name).numpy(), np.asarray(getattr(a_j, name)), err_msg=name
        )
    for name in ("env_row_cdf", "env_col_cdf", "env_pdf"):
        close(getattr(a_t, name), getattr(a_j, name), name)
    assert int(a_t.textures.n_levels.max()) == 7  # 64x64 down to 1x1


def _uv_inputs(n, seed):
    rng = np.random.RandomState(seed)
    uv = (rng.rand(n, 2) * 3.0 - 1.0).astype(np.float32)  # wraps both ways
    lod = (rng.rand(n) * 14.0 - 11.0).astype(np.float32)  # below level 0 to above the top
    aniso = (rng.randn(n, 2) * 0.02).astype(np.float32)
    aniso[: n // 8] = 0.0  # degenerate footprint: one probe spot
    return uv, lod, aniso


@pytest.mark.parametrize("mode", ["bilinear", "trilinear", "ewa"])
def test_eval_texture_matches_reference(textured, mode):
    """Every node of the pool (images, colorramp, blend, constants) and the
    constant fallback, at level 0, through the mip chain, and with EWA
    probes; with and without mip filtering in the statics."""
    _, (a_j, s_j), _, (a_t, s_t) = textured
    n_nodes = int(a_t.textures.ttype.shape[0])
    n = 4096
    uv, lod, aniso = _uv_inputs(n, 3)
    tid = np.random.RandomState(4).randint(-1, n_nodes, n).astype(np.int32)
    const = np.random.RandomState(5).rand(n, 3).astype(np.float32)
    if mode == "bilinear":
        cols = uv
    elif mode == "trilinear":
        cols = np.concatenate([uv, lod[:, None]], -1)
    else:
        cols = np.concatenate([uv, lod[:, None], aniso], -1)
    for static_j, static_t in ((s_j, s_t), (
        dataclasses.replace(s_j, mip_textures=False), dataclasses.replace(s_t, mip_textures=False)
    )):
        want = tex_j.eval_texture(static_j, a_j.textures, jnp.asarray(tid), jnp.asarray(cols),
                                  jnp.asarray(const))
        got = tex_t.eval_texture(static_t, a_t.textures, torch.from_numpy(tid).long(),
                                 torch.from_numpy(cols), torch.from_numpy(const))
        close(got, want, mode)
    assert np.ptp(np.asarray(want)) > 0.1


def _dirs(n, seed):
    d = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = (0.0, 1.0, 0.0)  # a pole
    d[1] = (np.nan, 0.0, 1.0)  # a non-finite direction gives no background
    return d


def test_environment_matches_reference(textured):
    """The lat-long lookup, background_radiance (mip lod on), the importance
    sampler and its pdf, from seeded uniforms and directions."""
    _, (a_j, s_j), _, (a_t, s_t) = textured
    n = 4096
    d = _dirs(n, 6)
    u_j = tex_j.eval_texture_dir(s_j, a_j.textures, jnp.full(n, int(a_j.bg_tex)), jnp.asarray(d),
                                 jnp.ones((n, 3)))
    u_t = tex_t.eval_texture_dir(s_t, a_t.textures, torch.full((n,), int(a_t.bg_tex)),
                                 torch.from_numpy(d), torch.ones(n, 3))
    close(u_t[2:], u_j[2:], "eval_texture_dir")
    close(lights_t.background_radiance(a_t, s_t, torch.from_numpy(d)),
          lights_j.background_radiance(a_j, s_j, jnp.asarray(d)), "background")
    close(lights_t.pdf_env_dir(a_t, s_t, torch.from_numpy(d[2:])),
          lights_j.pdf_env_dir(a_j, s_j, jnp.asarray(d[2:])), "pdf_env_dir")
    rng = np.random.RandomState(7)
    u1, u2 = rng.rand(2, n).astype(np.float32)
    u1[:4] = (0.0, 1.0 - 2**-24, 0.5, 0.25)
    ej = lights_j.sample_env_light(a_j, s_j, jnp.asarray(u1), jnp.asarray(u2))
    et = lights_t.sample_env_light(a_t, s_t, torch.from_numpy(u1), torch.from_numpy(u2))
    for name in ("wi", "pdf"):
        close(getattr(et, name), getattr(ej, name), name)
    # the sky's radiance at a sampled direction holds the limit on >= 99.5%
    # of lanes and 1e-3 on all: a direction on the sun's edge turns the two
    # frameworks' 1-ulp differences in sin/cos into a bilinear weight that
    # differs by ~1e-6, times the edge's contrast of 60 : 0.08
    for name in ("radiance", "ls"):
        got, want = getattr(et, name).numpy(), np.asarray(getattr(ej, name))
        lanes = np.isclose(got, want, **TOL).all(-1)
        assert lanes.mean() >= 0.995, (name, lanes.mean())
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=name)
    # the sun is sampled far more often than its solid angle
    assert (np.asarray(ej.radiance).max(-1) > 10.0).mean() > 0.3


def test_bisect_rows_matches_searchsorted():
    """_bisect_rows is bisect-right on each lane's row, flat zero-weight runs
    included, equal to the reference's."""
    rng = np.random.RandomState(8)
    w = rng.rand(6, 16).astype(np.float32)
    w[:, 4:9] = 0.0  # a flat run in every row
    cdf = np.concatenate([np.zeros((6, 1)), np.cumsum(w, 1) / w.sum(1, keepdims=True)], 1)
    cdf = cdf.astype(np.float32)
    row = rng.randint(0, 6, 2048)
    u = np.concatenate([rng.rand(2000), cdf[row[2000:], 4]]).astype(np.float32)
    got = lights_t._bisect_rows(torch.from_numpy(cdf), torch.from_numpy(row), torch.from_numpy(u), 16)
    want = lights_j._bisect_rows(jnp.asarray(cdf), jnp.asarray(row), jnp.asarray(u), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = [np.searchsorted(cdf[r], x, side="right") - 1 for r, x in zip(row, u)]
    np.testing.assert_array_equal(got.numpy(), np.clip(ref, 0, 15))


def test_dpdf_matches_reference():
    """build and build_np against kazen_tpu.core.dpdf; sample (bisect-right:
    a flat zero-weight run is never picked, even at its CDF value),
    sample_reuse and pdf_of on the reference's table."""
    rng = np.random.RandomState(9)
    w = rng.rand(40).astype(np.float32)
    zero = [0, 10, 11, 12, 39]
    w[zero] = 0.0
    dj, dt = dpdf_j.build(w), dpdf_t.build(w, device="cpu")
    close(dt.cdf, dj.cdf, "cdf")
    close(dt.normalization, dj.normalization, "normalization")
    cdf_np, norm_np = dpdf_t.build_np(w)
    cdf_j, norm_j = dpdf_j.build_np(w)
    np.testing.assert_array_equal(cdf_np, cdf_j)
    assert norm_np == norm_j
    dt = dpdf_t.DiscretePDF(torch.tensor(np.asarray(dj.cdf)), torch.tensor(float(dj.normalization)))
    u = np.concatenate([rng.rand(4000), np.asarray(dj.cdf)[[1, 10, 12, 13]]]).astype(np.float32)
    idx_t = dpdf_t.sample(dt, torch.from_numpy(u))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(dpdf_j.sample(dj, jnp.asarray(u))))
    assert not np.isin(idx_t.numpy(), zero).any()
    it, rt = dpdf_t.sample_reuse(dt, torch.from_numpy(u))
    ij, rj = dpdf_j.sample_reuse(dj, jnp.asarray(u))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    close(rt, rj, "reuse")
    close(dpdf_t.pdf_of(dt, it), dpdf_j.pdf_of(dj, ij), "pdf_of")


@pytest.mark.parametrize("kind", ["gaussian", "box"])
def test_scatter_splat_matches_reference(kind):
    """film.splat on seeded samples (some off the image, some with invalid
    radiance) against kazen_tpu.film.film.splat."""
    from types import SimpleNamespace

    static = SimpleNamespace(width=20, height=12, rfilter_kind=kind, rfilter_radius=2.0,
                             rfilter_stddev=0.5, rfilter_b=1 / 3, rfilter_c=1 / 3)
    rng = np.random.RandomState(12)
    n = 3000
    ps = (rng.rand(n, 2) * [22.0, 14.0] - 1.0).astype(np.float32)
    ps[:50, 0] = 0x7FFFFF + rng.rand(50)  # the chunked pass's padding lanes
    val = rng.rand(n, 3).astype(np.float32)
    val[50:60] = np.nan
    val[60:70, 1] = -1.0
    want = film_j.splat(static, jnp.zeros((12, 20, 4)), jnp.asarray(ps), jnp.asarray(val))
    got = film_t.splat(static, torch.zeros(12, 20, 4), torch.from_numpy(ps), torch.from_numpy(val))
    close(got, want, "film")
    assert bool(torch.isfinite(got).all())


def test_texture_footprint_matches_reference(textured):
    """_texture_footprint on the hits of the reference shim's trace rows:
    the mip level and the major half-axis, with and without anisotropy, and
    finite on miss lanes (the 1e8 clamp)."""
    _, (a_j, s_j), _, (a_t, s_t) = textured
    rng = np.random.RandomState(10)
    n = 2048
    o = (np.asarray([[0.0, 1.0, -0.8]]) + 0.3 * rng.randn(n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(rng.rand(n) < 0.1, -1.0, 3.0e38).astype(np.float32)  # some misses
    rows = np.asarray(ct_j.trace(a_j.trace_tables, jnp.asarray(o), jnp.asarray(d), mint, maxt,
                                 mode="shim"))
    its_j = inter_j.prepare_from_rows(RaysJ(o=o, d=d, mint=mint, maxt=maxt), rows)[1]
    its_t = inter_t.prepare_from_rows(
        RaysT(*(torch.from_numpy(x) for x in (o, d, mint, maxt))), torch.tensor(rows)
    )[1]
    for aniso in (True, False):
        sj = dataclasses.replace(s_j, aniso_textures=aniso)
        st = dataclasses.replace(s_t, aniso_textures=aniso)
        lod_j, ax_j = pm_j._texture_footprint(sj, its_j, jnp.asarray(d))
        lod_t, ax_t = pm_t._texture_footprint(st, its_t, torch.from_numpy(d))
        close(lod_t, lod_j, "lod")
        assert bool(torch.isfinite(lod_t).all())
        if aniso:
            close(ax_t[0], ax_j[0], "maj_du")
            close(ax_t[1], ax_j[1], "maj_dv")
        else:
            assert ax_t is None and ax_j is None


def _lanes_reference(a_j, s_j, sample):
    spec = render_j.sampler_spec(s_j)
    ys, xs = np.meshgrid(np.arange(s_j.height), np.arange(s_j.width), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    st = streams_j.init_stream(spec, px.astype(np.uint32), py.astype(np.uint32), sample)
    st, jitter = streams_j.next_pixel_2d(spec, st)
    ps = jnp.stack([jnp.asarray(px), jnp.asarray(py)], -1).astype(jnp.float32) + jitter
    st, ap = streams_j.next_2d(spec, st)
    return spec, st, cam_j.sample_ray(a_j, s_j, ps, ap)


def _lanes_port(a_t, s_t, sample):
    spec = render_t.sampler_spec(s_t, "cpu")
    px, py = render_t.pixel_grid(s_t, a_t.device)
    st = streams_t.init_stream(spec, px, py, sample)
    st, jitter = streams_t.next_pixel_2d(spec, st)
    st, ap = streams_t.next_2d(spec, st)
    ps = torch.stack([px, py], -1).to(torch.float32) + jitter
    return spec, st, cam_t.sample_ray(a_t, s_t, ps, ap)


def _assert_render_close(got, want):
    got, want = got.reshape(-1, 3), want.reshape(-1, 3)
    lanes = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert lanes.mean() >= 0.99, lanes.mean()
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=5e-3)
    assert want.mean() > 0.01


@pytest.fixture(scope="module")
def plain_textured():
    """The textured scene without composite nodes: the reference compiles
    its wavefront in tens of seconds this way, instead of minutes (the
    composite nodes are held above, lookup by lookup)."""
    desc = textured_scene(composite=False)
    return compile_reference(desc), compile_port(desc)


def test_textured_wavefront_matches_reference(plain_textured):
    """li_wavefront on the textured scene (pmj02bn, sample index 2): image
    textures with mips and EWA, the normal map, the rough* models and the
    importance-sampled sky on the path_mis route."""
    (a_j, s_j), (a_t, s_t) = plain_textured
    assert s_t.has_image_textures and s_t.env_importance and not s_t.has_composite_textures
    _, li_j, nr_j = pm_j.li_wavefront(a_j, s_j, *_lanes_reference(a_j, s_j, 2))
    _, li_t, nr_t = pm_t.li_wavefront(a_t, s_t, *_lanes_port(a_t, s_t, 2))
    _assert_render_close(li_t.numpy(), np.asarray(li_j))
    assert abs(float(nr_t) - float(nr_j)) <= 1e-3 * float(nr_j)


def test_lane_chunked_render_matches_grid(plain_textured):
    """render(lane_chunk=160) splits the 24x24 frame into chunks (the last
    padded with off-image lanes) and adds them with the scatter splat: the
    same samples as the full-grid render, summed in another order."""
    _, (a_t, s_t) = plain_textured
    chunks = render_t.lane_chunks(s_t, a_t.device, 160)
    assert len(chunks) == 4 and int(chunks[-1][0][-1]) == 0x7FFFFF
    img = render_t.render(a_t, s_t, spp=2, lane_chunk=160, device="cpu").numpy()
    grid = render_t.render(a_t, s_t, spp=2, device="cpu").numpy()
    _assert_render_close(img, grid)


def _con2(width, height, spp):
    """BASELINE's config 4 (kazen-con-2: diffuse walls and a kiss sphere,
    every material parameter a constant; a lat-long image background, mip
    filtering, pmj02bn) at ``width`` x ``height``, compiled on the CPU."""
    return compile_scene(bc.at_size(bc.config_scene(4, spp=spp), width, height), device="cpu")


def test_untextured_fields_render_bit_for_bit():
    """con-2's only image is its background, so no material field is
    textured: its lookups return the rows' constants without the image path
    (and without the footprint), and the image equals the one every lookup
    running the image path gives (textured_fields None), bit for bit."""
    a_t, s_t = _con2(64, 36, 2)
    assert s_t.has_image_textures and s_t.mip_textures and s_t.textured_fields == ()
    img = render_t.render(a_t, s_t, device="cpu")
    img_image_path = render_t.render(
        a_t, dataclasses.replace(s_t, textured_fields=None), device="cpu")
    assert img.mean() > 0.01
    assert torch.equal(img, img_image_path)


def test_untextured_fields_gradients_match_the_image_path():
    """The constant route gives the image path's loss bit for bit and its
    gradients (materials, the background's texels, the background colour;
    one pass of con-2 at 16x9), whose torch.where gave the discarded fetch
    nothing. The gradients agree to the last bits only: without the where
    nodes the backward adds a parameter's uses in another order."""
    a_t, s_t = _con2(16, 9, 1)
    spec = render_t.sampler_spec(s_t, "cpu")
    target = torch.full((s_t.height, s_t.width, 3), 0.25)
    losses, grads = [], []
    for static in (s_t, dataclasses.replace(s_t, textured_fields=None)):
        params = inverse.as_leaves(inverse.get_params(a_t, ("materials", "texels", "bg_color")))
        loss = inverse.image_loss(inverse.render_image(a_t, static, spec, params, [0]), target)
        losses.append(loss)
        grads.append(torch.autograd.grad(loss, inverse.leaves(params), allow_unused=True))
    assert torch.equal(*losses)
    assert sum(g is not None and bool(g.abs().sum() > 0) for g in grads[0]) >= 5
    for g, g_image_path in zip(*grads):
        assert (g is None) == (g_image_path is None)
        if g is not None:
            torch.testing.assert_close(g, g_image_path, rtol=1e-5,
                                       atol=1e-6 * float(g_image_path.abs().max()))


@pytest.fixture(scope="module")
def base_textured():
    """(the reference's compile, the port's) of a scene whose materials
    texture their base colour alone."""
    desc = base_textured_scene()
    return compile_reference(desc), compile_port(desc)


def test_base_only_textures_match_reference(base_textured):
    """Mixed fields: the compiler names ``base`` alone; base keeps the image
    path on every lane of that field, metallic, roughness and the normal
    take their constants, and li_wavefront (pmj02bn, sample index 2) holds
    to the reference at test_textured_wavefront_matches_reference's limits
    and to the all-image path bit for bit."""
    (a_j, s_j), (a_t, s_t) = base_textured
    assert s_t.textured_fields == ("base",) and s_t.mip_textures
    _, li_j, nr_j = pm_j.li_wavefront(a_j, s_j, *_lanes_reference(a_j, s_j, 2))
    _, li_t, nr_t = pm_t.li_wavefront(a_t, s_t, *_lanes_port(a_t, s_t, 2))
    _assert_render_close(li_t.numpy(), np.asarray(li_j))
    assert abs(float(nr_t) - float(nr_j)) <= 1e-3 * float(nr_j)
    s_image_path = dataclasses.replace(s_t, textured_fields=None)
    _, li_image_path, _ = pm_t.li_wavefront(a_t, s_image_path, *_lanes_port(a_t, s_t, 2))
    assert torch.equal(li_t, li_image_path)
