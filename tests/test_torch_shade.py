"""kazen_tpu_torch's shading stages against kazen_tpu's on seeded inputs:
the shade prep from trace rows, camera rays, area-light sampling and the
diffuse and kiss BSDFs. XLA:CPU and PyTorch evaluate transcendentals (and
may contract products) differently, so the comparisons hold to rtol 1e-4 /
atol 1e-6 rather than bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.accel import cluster_trace as ct_j
from kazen_tpu.accel.intersect import Rays as RaysJ
from kazen_tpu.core import math as km_j
from kazen_tpu.integrate import camera as cam_j
from kazen_tpu.scene import description as DJ
from kazen_tpu.shade import bsdf as bsdf_j
from kazen_tpu.shade import interaction as inter_j
from kazen_tpu.shade import lights as lights_j
from kazen_tpu_torch.accel.intersect import Rays as RaysT
from kazen_tpu_torch.core import math as km_t
from kazen_tpu_torch.integrate import camera as cam_t
from kazen_tpu_torch.shade import bsdf as bsdf_t
from kazen_tpu_torch.shade import interaction as inter_t
from kazen_tpu_torch.shade import lights as lights_t

from torch_port_helpers import compile_port, compile_reference, materials_scene, mixed_scene

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def scenes():
    desc = materials_scene()
    return compile_reference(desc), compile_port(desc)


def close(got, want, err=""):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=err
    )


def _unit(rng, n, zmin=None):
    v = rng.randn(n, 3).astype(np.float32)
    if zmin is not None:
        v[:, 2] = np.abs(v[:, 2]) + zmin
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_prepare_from_rows(scenes):
    """Shade prep from the same trace rows (the reference shim's)."""
    (a_j, _), _ = scenes
    rng = np.random.RandomState(0)
    n = 1024
    o = np.asarray([[0.0, 1.0, -0.5]], np.float32) + 0.3 * rng.randn(n, 3).astype(np.float32)
    d = _unit(rng, n)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, 3.0e38, np.float32)
    rows = np.asarray(
        ct_j.trace(a_j.trace_tables, jnp.asarray(o), jnp.asarray(d), mint, maxt, mode="shim")
    )
    assert (rows[3] >= 0).mean() > 0.5
    hit_j, its_j = inter_j.prepare_from_rows(RaysJ(o=o, d=d, mint=mint, maxt=maxt), rows)
    hit_t, its_t = inter_t.prepare_from_rows(
        RaysT(*(torch.from_numpy(x) for x in (o, d, mint, maxt))), torch.tensor(rows)
    )
    for name in ("valid", "face"):
        np.testing.assert_array_equal(getattr(hit_t, name).numpy(), np.asarray(getattr(hit_j, name)))
    for name in ("t", "u", "v"):
        close(getattr(hit_t, name), getattr(hit_j, name), name)
    for name in ("p", "uv", "dpdu", "dpdv"):
        close(getattr(its_t, name), getattr(its_j, name), name)
    for frame in ("sh_frame", "geo_frame"):
        for axis in ("s", "t", "n"):
            close(getattr(getattr(its_t, frame), axis), getattr(getattr(its_j, frame), axis),
                  f"{frame}.{axis}")
    for name in ("material", "light", "valid", "cluster"):
        np.testing.assert_array_equal(getattr(its_t, name).numpy(), np.asarray(getattr(its_j, name)))


@pytest.mark.parametrize("kind", ["perspective", "thinlens"])
def test_camera_rays(kind):
    desc = materials_scene(width=20, height=12)
    if kind == "thinlens":
        c = desc.camera
        desc = dataclasses.replace(desc, camera=DJ.ThinlensCamera(
            width=c.width, height=c.height, fov=c.fov, to_world=c.to_world,
            aperture_radius=0.05, focus_distance=2.5,
        ))
    (a_j, s_j), (a_t, s_t) = compile_reference(desc), compile_port(desc)
    assert s_t.camera_kind == kind
    rng = np.random.RandomState(1)
    n = 240
    ps = (rng.rand(n, 2) * [20, 12]).astype(np.float32)
    ap = rng.rand(n, 2).astype(np.float32)
    rj = cam_j.sample_ray(a_j, s_j, jnp.asarray(ps), jnp.asarray(ap))
    rt = cam_t.sample_ray(a_t, s_t, torch.from_numpy(ps), torch.from_numpy(ap))
    for name in ("o", "d", "mint", "maxt"):
        close(getattr(rt, name), getattr(rj, name), name)


def test_area_light_sample_eval_pdf(scenes):
    (a_j, s_j), (a_t, _) = scenes
    rng = np.random.RandomState(2)
    n = 512
    ref_p = (np.asarray([[0.0, 0.8, 0.0]]) + 0.5 * rng.randn(n, 3)).astype(np.float32)
    u = rng.rand(3, n).astype(np.float32)
    lidx = np.zeros(n, np.int32)
    sj = lights_j.sample_area_light(a_j, jnp.asarray(lidx), jnp.asarray(ref_p), *map(jnp.asarray, u))
    st = lights_t.sample_area_light(
        a_t, torch.from_numpy(lidx).long(), torch.from_numpy(ref_p), *map(torch.from_numpy, u)
    )
    for name in ("p", "n", "wi", "dist", "pdf", "ls"):
        close(getattr(st, name), getattr(sj, name), name)
    assert (np.asarray(sj.pdf) > 0).mean() > 0.3  # both sides of the light
    assert (np.asarray(sj.pdf) == 0).any()
    np.testing.assert_array_equal(
        lights_t.select_uniform(3, torch.from_numpy(u[0])).numpy(),
        np.asarray(lights_j.select_uniform(3, jnp.asarray(u[0]))),
    )


def _bsdf_inputs(scenes, seed, n=2048):
    (a_j, s_j), (a_t, s_t) = scenes
    rng = np.random.RandomState(seed)
    mat = rng.randint(0, s_t.num_materials, n).astype(np.int32)
    assert set(np.asarray(a_j.materials.btype)[mat]) == {0, 8}  # diffuse and kiss
    wi = _unit(rng, n)
    wi[: n * 3 // 4, 2] = np.abs(wi[: n * 3 // 4, 2])  # mostly above the surface
    wo = _unit(rng, n)
    accum = (0.3 * rng.rand(n)).astype(np.float32)
    uv = rng.rand(n, 2).astype(np.float32)
    nrm = _unit(rng, n)
    return mat, wi, wo, accum, uv, nrm, rng


def _ctx_pair(scenes, mat, wi, uv, nrm):
    (a_j, s_j), (a_t, s_t) = scenes
    fj = km_j.frame_from_normal(jnp.asarray(nrm))
    ctx_j = bsdf_j.make_ctx(
        s_j, a_j, jnp.asarray(mat), jnp.asarray(uv), fj, fj.s, jnp.asarray(wi)
    )
    ft = km_t.frame_from_normal(torch.from_numpy(nrm))
    ctx_t = bsdf_t.make_ctx(
        s_t, a_t, torch.from_numpy(mat).long(), torch.from_numpy(uv), ft, torch.from_numpy(wi)
    )
    return ctx_j, ctx_t


def test_bsdf_eval_pdf(scenes):
    (a_j, s_j), (_, s_t) = scenes
    mat, wi, wo, accum, uv, nrm, _ = _bsdf_inputs(scenes, 3)
    ctx_j, ctx_t = _ctx_pair(scenes, mat, wi, uv, nrm)
    fj, pj = bsdf_j.eval_pdf_ctx(s_j, a_j, ctx_j, jnp.asarray(wo), jnp.asarray(accum))
    ft, pt = bsdf_t.eval_pdf_ctx(s_t, ctx_t, torch.from_numpy(wo), torch.from_numpy(accum))
    close(ft, fj, "eval")
    close(pt, pj, "pdf")
    assert (np.asarray(pj) > 0).mean() > 0.3


def test_bsdf_sample(scenes):
    (a_j, s_j), (_, s_t) = scenes
    mat, wi, _, accum, uv, nrm, rng = _bsdf_inputs(scenes, 4)
    s1 = rng.rand(len(mat)).astype(np.float32)
    s2 = rng.rand(len(mat), 2).astype(np.float32)
    ctx_j, ctx_t = _ctx_pair(scenes, mat, wi, uv, nrm)
    rj = bsdf_j.sample_ctx(s_j, a_j, ctx_j, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(accum))
    rt = bsdf_t.sample_ctx(
        s_t, ctx_t, torch.from_numpy(s1), torch.from_numpy(s2), torch.from_numpy(accum)
    )
    for name in ("wo", "weight", "eta", "pdf"):
        close(getattr(rt, name), getattr(rj, name), name)
    np.testing.assert_array_equal(rt.is_discrete.numpy(), np.asarray(rj.is_discrete))
    assert (np.asarray(rj.weight) > 0).any(-1).mean() > 0.5


def test_regularize(scenes):
    (a_j, s_j), (_, s_t) = scenes
    mat, wi, _, _, uv, nrm, _ = _bsdf_inputs(scenes, 5, n=256)
    _, ctx_t = _ctx_pair(scenes, mat, wi, uv, nrm)
    want = bsdf_j.regularize_resolved(s_j, a_j, jnp.asarray(mat), jnp.asarray(uv))
    np.testing.assert_array_equal(bsdf_t.regularize_ctx(s_t, ctx_t).numpy(), np.asarray(want))


def test_unported_bsdf_type_raises(scenes):
    """Every material type of the reference is ported (the rough* models and
    the normal map are held in test_torch_textures.py); the dispatch refuses
    an id no model has, as the reference's does."""
    _, (_, s_t) = scenes
    assert bsdf_t._base_types(dataclasses.replace(s_t, btypes_present=(0, 5, 6, 7, 9))) == (
        0, 5, 6, 7,
    )
    with pytest.raises(ValueError, match="unhandled btype"):
        bsdf_t._base_types(dataclasses.replace(s_t, btypes_present=(0, 10)))


@pytest.fixture(scope="module")
def mixed():
    desc = mixed_scene()
    return compile_reference(desc), compile_port(desc)


BTYPES = {"dielectric": 1, "mirror": 2, "lambertian": 3, "ggx": 4}


@pytest.mark.parametrize("name", sorted(BTYPES))
def test_bsdf_type_matches_reference(mixed, name):
    """sample and eval_pdf of one material type on seeded inputs, against
    kazen_tpu.shade.bsdf, to rtol 1e-5 / atol 1e-6. Directions cover both
    hemispheres: the dielectric gets lanes outside, inside and in total
    internal reflection. The sampled direction holds that limit on >= 99.5%
    of lanes and 1e-3 on all: where a sample lies near the hemisphere's rim
    (s2 near 1), sqrt(1 - x^2) cancels and turns the two frameworks' 1-ulp
    differences in cos/sin into a few 1e-5."""
    (a_j, s_j), (a_t, s_t) = mixed
    ids = np.flatnonzero(np.asarray(a_j.materials.btype) == BTYPES[name])
    assert len(ids) == 1
    rng = np.random.RandomState(8)
    n = 2048
    mat = np.full(n, ids[0], np.int32)
    wi, wo = _unit(rng, n), _unit(rng, n)
    wi[: n // 2, 2] = np.abs(wi[: n // 2, 2])
    accum = (0.3 * rng.rand(n)).astype(np.float32)
    uv = rng.rand(n, 2).astype(np.float32)
    s1 = rng.rand(n).astype(np.float32)
    s2 = rng.rand(n, 2).astype(np.float32)
    ctx_j, ctx_t = _ctx_pair(mixed, mat, wi, uv, _unit(rng, n))
    rj = bsdf_j.sample_ctx(s_j, a_j, ctx_j, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(accum))
    rt = bsdf_t.sample_ctx(
        s_t, ctx_t, torch.from_numpy(s1), torch.from_numpy(s2), torch.from_numpy(accum)
    )
    tol = dict(rtol=1e-5, atol=1e-6)
    wo_t, wo_j = rt.wo.numpy(), np.asarray(rj.wo)
    lanes = np.isclose(wo_t, wo_j, **tol).all(-1)
    assert lanes.mean() >= 0.995, (lanes.mean(), np.abs(wo_t - wo_j).max())
    np.testing.assert_allclose(wo_t, wo_j, rtol=0.0, atol=1e-3, err_msg="wo")
    for field in ("weight", "eta", "pdf"):
        np.testing.assert_allclose(
            getattr(rt, field).numpy(), np.asarray(getattr(rj, field)), err_msg=field, **tol
        )
    np.testing.assert_array_equal(rt.is_discrete.numpy(), np.asarray(rj.is_discrete))
    assert (np.asarray(rj.weight) > 0).any(-1).mean() > 0.4
    fj, pj = bsdf_j.eval_pdf_ctx(s_j, a_j, ctx_j, jnp.asarray(wo), jnp.asarray(accum))
    ft, pt = bsdf_t.eval_pdf_ctx(s_t, ctx_t, torch.from_numpy(wo), torch.from_numpy(accum))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), err_msg="eval", **tol)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), err_msg="pdf", **tol)
    if name == "dielectric":
        cos_i = wi[:, 2]
        sin_t2 = (1.5046 / 1.000277) ** 2 * (1.0 - cos_i**2)  # leaving the glass
        assert (cos_i > 0).any() and (cos_i < 0).any() and ((cos_i < 0) & (sin_t2 > 1)).any()
        eta = np.asarray(rj.eta)
        assert (eta == 1.0).any() and (eta != 1.0).any()  # both lobes chosen


def test_refract_fresnel_match_reference():
    rng = np.random.RandomState(9)
    n = 1024
    wi = _unit(rng, n)
    nrm = _unit(rng, n)
    eta = (1.0 + rng.rand(n)).astype(np.float32)
    close(km_t.refract(torch.from_numpy(wi), torch.from_numpy(nrm), torch.from_numpy(eta)),
          km_j.refract(jnp.asarray(wi), jnp.asarray(nrm), jnp.asarray(eta)), "refract")
    cos_i = (2.0 * rng.rand(n) - 1.0).astype(np.float32)
    ext = np.where(rng.rand(n) < 0.1, 1.5, 1.000277).astype(np.float32)
    got = km_t.fresnel(torch.from_numpy(cos_i), torch.from_numpy(ext), torch.tensor(1.5))
    want = km_j.fresnel(jnp.asarray(cos_i), jnp.asarray(ext), jnp.asarray(1.5, jnp.float32))
    close(got, want, "fresnel")
    assert (np.asarray(want) == 1.0).any() and (np.asarray(want) == 0.0).any()


@pytest.mark.parametrize(
    "name",
    ["square_to_uniform_square", "square_to_tent", "square_to_uniform_disk",
     "square_to_uniform_sphere", "square_to_uniform_hemisphere",
     "square_to_cosine_hemisphere"],
)
def test_warps(name):
    from kazen_tpu.core import warp as warp_j
    from kazen_tpu_torch.core import warp as warp_t

    s = np.random.RandomState(6).rand(512, 2).astype(np.float32)
    s[0] = 0.5  # the concentric map's degenerate centre
    got = getattr(warp_t, name)(torch.from_numpy(s))
    want = getattr(warp_j, name)(jnp.asarray(s))
    close(got, want, name)
    close(getattr(warp_t, name + "_pdf")(got), getattr(warp_j, name + "_pdf")(want), name)


def test_frames_and_color():
    rng = np.random.RandomState(7)
    n = _unit(rng, 256)
    fj, ft = km_j.frame_from_normal(jnp.asarray(n)), km_t.frame_from_normal(torch.from_numpy(n))
    v = rng.randn(256, 3).astype(np.float32)
    close(ft.to_local(torch.from_numpy(v)), fj.to_local(jnp.asarray(v)))
    close(ft.to_world(torch.from_numpy(v)), fj.to_world(jnp.asarray(v)))
    c = rng.rand(256, 3).astype(np.float32) * 1.2
    close(km_t.to_srgb(torch.from_numpy(c)), km_j.to_srgb(jnp.asarray(c)))
    close(km_t.luminance(torch.from_numpy(c)), km_j.luminance(jnp.asarray(c)))


@pytest.fixture(scope="module")
def textured():
    """The textured scene (image textures, normalmap, rough* models; the
    composite nodes are held in test_torch_textures.py), compiled by the
    reference and carried across."""
    from torch_port_helpers import port_from_reference, textured_scene

    a_j, s_j = compile_reference(textured_scene(width=8, height=8, composite=False))
    return (a_j, s_j), port_from_reference(a_j, s_j)


def _typed_inputs(btypes, btype, seed, n=2048):
    ids = np.flatnonzero(btypes == btype)
    assert len(ids) == 1
    rng = np.random.RandomState(seed)
    wi, wo = _unit(rng, n), _unit(rng, n)
    wi[: n // 2, 2] = np.abs(wi[: n // 2, 2])
    wo[: n // 4, 2] = np.abs(wo[: n // 4, 2])
    return (
        np.full(n, ids[0], np.int32), wi, wo, (0.3 * rng.rand(n)).astype(np.float32),
        rng.rand(n, 2).astype(np.float32), rng.rand(n).astype(np.float32),
        rng.rand(n, 2).astype(np.float32), _unit(rng, n),
    )


def _check_type(pair, btype, seed, lod=None):
    """eval_pdf_ctx of one material type against the reference at rtol 1e-5
    / atol 1e-6 on every lane, and sample_ctx: the sampled direction at that
    limit on >= 99.5% of lanes and 1e-3 on all, as
    test_bsdf_type_matches_reference explains; the weight and pdf of the
    sample at rtol 1e-4 on >= 99.5% of lanes and 1e-3 on all, because a
    Beckmann lobe's exp(-tan^2 / alpha^2) multiplies the direction's 1-ulp
    differences by about 1 / alpha^2 (123 at roughness 0.3).
    Returns (the port's context, the reference's context and sample)."""
    (a_j, s_j), (a_t, s_t) = pair
    mat, wi, wo, accum, uv, s1, s2, nrm = _typed_inputs(
        np.asarray(a_j.materials.btype), btype, seed
    )
    fj = km_j.frame_from_normal(jnp.asarray(nrm))
    ft = km_t.frame_from_normal(torch.from_numpy(nrm))
    kw_j, kw_t = {}, {}
    if lod is not None:
        lod_, aniso = lod
        kw_j = dict(lod=jnp.asarray(lod_), aniso=tuple(jnp.asarray(a) for a in aniso))
        kw_t = dict(lod=torch.from_numpy(lod_), aniso=tuple(torch.from_numpy(a) for a in aniso))
    ctx_j = bsdf_j.make_ctx(s_j, a_j, jnp.asarray(mat), jnp.asarray(uv), fj, fj.s,
                            jnp.asarray(wi), **kw_j)
    ctx_t = bsdf_t.make_ctx(s_t, a_t, torch.from_numpy(mat).long(), torch.from_numpy(uv), ft,
                            torch.from_numpy(wi), dpdu=ft.s, **kw_t)
    tol = dict(rtol=1e-5, atol=1e-6)
    fj_, pj_ = bsdf_j.eval_pdf_ctx(s_j, a_j, ctx_j, jnp.asarray(wo), jnp.asarray(accum))
    ft_, pt_ = bsdf_t.eval_pdf_ctx(s_t, ctx_t, torch.from_numpy(wo), torch.from_numpy(accum))
    np.testing.assert_allclose(ft_.numpy(), np.asarray(fj_), err_msg="eval", **tol)
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj_), err_msg="pdf", **tol)
    assert (np.asarray(pj_) > 0).mean() > 0.1
    rj = bsdf_j.sample_ctx(s_j, a_j, ctx_j, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(accum))
    rt = bsdf_t.sample_ctx(s_t, ctx_t, torch.from_numpy(s1), torch.from_numpy(s2),
                           torch.from_numpy(accum))
    for field, rtol in (("wo", 1e-5), ("weight", 1e-4), ("pdf", 1e-4)):
        got, want = getattr(rt, field).numpy(), np.asarray(getattr(rj, field))
        lanes = np.isclose(got, want, rtol=rtol, atol=1e-6)
        lanes = lanes.all(-1) if lanes.ndim == 2 else lanes
        assert lanes.mean() >= 0.995, (field, lanes.mean())
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5, err_msg=field)
    np.testing.assert_allclose(rt.eta.numpy(), np.asarray(rj.eta), err_msg="eta", **tol)
    np.testing.assert_array_equal(rt.is_discrete.numpy(), np.asarray(rj.is_discrete))
    assert (np.asarray(rj.weight) > 0).any(-1).mean() > 0.1
    return ctx_t, ctx_j, rj


@pytest.mark.parametrize("name", ["roughconductor", "roughplastic", "roughdielectric"])
def test_rough_bsdfs_match_reference(textured, name):
    btype = {"roughconductor": 5, "roughplastic": 6, "roughdielectric": 7}[name]
    _, _, rj = _check_type(textured, btype, 20 + btype)
    if name == "roughdielectric":  # both lobes, and both sides of the surface
        eta = np.asarray(rj.eta)
        assert (eta == 1.0).any() and (eta != 1.0).any()


def test_normalmap_matches_reference(textured):
    """The normalmap wrapper over diffuse: the perturbed frame from the
    tangent-space texture, the hemisphere shortcut and the rejection of
    flipped directions."""
    ctx_t, _, _ = _check_type(textured, 9, 31)
    assert 0.3 < ctx_t.perturbed.float().mean().item() < 1.0


def test_textured_kiss_with_footprint_matches_reference(textured):
    """kiss with image and composite textures fetched through the mip
    footprint (lod and the EWA half-axis threaded as uv columns)."""
    rng = np.random.RandomState(40)
    n = 2048
    lod = (rng.rand(n) * 10.0 - 9.0).astype(np.float32)
    aniso = tuple((rng.randn(n) * 0.01).astype(np.float32) for _ in range(2))
    ctx_t, ctx_j, _ = _check_type(textured, 8, 41, lod=(lod, aniso))
    assert ctx_t.uv.shape == (n, 5)
    (a_j, s_j), (_, s_t) = textured
    np.testing.assert_allclose(
        bsdf_t.regularize_ctx(s_t, ctx_t).numpy(),
        np.asarray(bsdf_j.regularize_ctx(s_j, a_j, ctx_j)), rtol=1e-5, atol=1e-6,
    )
