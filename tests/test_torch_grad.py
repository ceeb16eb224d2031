"""Gradients through the port: autodiff against finite differences (the
counterparts of tests/test_grad.py, at its tolerances), the port's
gradients against kazen_tpu's, and the megakernel route, which
diff/inverse.py must leave for the wavefront."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
from kazen_tpu.diff.inverse import apply_params as apply_j
from kazen_tpu.dist.sharding import material_float_params as mfp_j
from kazen_tpu.integrate.render import render as render_j
from kazen_tpu.scene import description as DJ
from kazen_tpu_torch.core import math as km
from kazen_tpu_torch.diff import inverse as inv
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.scene import compiler as comp_t
from kazen_tpu_torch.shade import bsdf as bsdf_t

from torch_port_helpers import (
    assert_grads_close,
    compile_port,
    compile_reference,
    multi_cluster_scene,
    port_from_reference,
    textured_scene,
    to_port,
)


def _grad(fn, x):
    x = x.detach().clone().requires_grad_(True)
    fn(x).backward()
    return x.grad


def _loss_for(desc, field, spp):
    """mean(render) as a function of one material field, on the port."""
    arrays, static = compile_port(desc)

    def loss(val):
        mats = dataclasses.replace(arrays.materials, **{field: val})
        return render_t.render(dataclasses.replace(arrays, materials=mats), static, spp=spp,
                               device="cpu").mean()

    return loss, getattr(arrays.materials, field)


def _fd(loss, base, e, h):
    with torch.no_grad():
        return (float(loss(base + e)) - float(loss(base - e))) / (2 * h)


def test_grad_albedo_matches_fd():
    loss, base = _loss_for(scenes.cornell_box(width=12, height=12, spp=2, max_depth=2),
                           "base_color", spp=2)
    g = _grad(loss, base)
    h = 1e-3
    for mi, ch in [(0, 0), (3, 1)]:
        e = torch.zeros_like(base)
        e[mi, ch] = h
        fd = _fd(loss, base, e, h)
        ad = float(g[mi, ch])
        assert abs(fd - ad) <= 2e-3 * max(abs(fd), abs(ad), 1e-3), (mi, ch, fd, ad)


def test_grad_kiss_roughness_reparam_matches_fd():
    """Reparameterized VNDF sampling at the BSDF level: the sampled lobe is
    a smooth function of roughness given fixed uniforms. Each lane reads a
    material row of its own, so one backward gives every lane's
    derivative."""
    desc = scenes.cornell_box(width=8, height=8, spp=1, wall_bsdf=DJ.KazenStandard(
        base_color=DJ.ConstantTexture((0.6, 0.6, 0.6)), roughness=DJ.ConstantTexture((0.4,) * 3)))
    arrays, static = compile_port(desc)
    n = 50_000
    r = np.random.default_rng(3)
    s1 = torch.from_numpy(r.random(n, dtype=np.float32))
    s2 = torch.from_numpy(r.random((n, 2), dtype=np.float32))
    uv = torch.from_numpy(r.random((n, 2), dtype=np.float32))
    frame = km.frame_from_normal(torch.tensor([0.0, 0.0, 1.0]).expand(n, 3).contiguous())
    wi = torch.tensor([np.sin(0.5), 0.0, np.cos(0.5)], dtype=torch.float32).expand(n, 3)
    rows = arrays.materials.rows(torch.zeros(n, dtype=torch.int64))
    lane = torch.arange(n)

    def per_lane(rough):
        sc = dataclasses.replace(arrays, materials=dataclasses.replace(rows, roughness=rough))
        res = bsdf_t.sample(static, sc, lane, uv, frame, frame.s, wi, s1, s2, torch.zeros(n))
        return km.luminance(res.weight) * (1.0 + res.wo[:, 2])

    x = torch.full((n,), 0.4)
    ad = _grad(lambda v: per_lane(v).sum(), x).numpy().astype(np.float64)
    h = 2e-3
    with torch.no_grad():
        fd = (per_lane(x + h).numpy().astype(np.float64)
              - per_lane(x - h).numpy().astype(np.float64)) / (2 * h)
    err = np.abs(fd - ad)
    good = err <= 0.02 * np.maximum(np.abs(ad), 0.05)
    assert good.mean() > 0.99, (good.mean(), np.median(err))
    keep = err < np.quantile(err, 0.995)
    np.testing.assert_allclose(fd[keep].mean(), ad[keep].mean(), rtol=0.05, atol=1e-4)


def test_grad_light_radiance_linear():
    """The image is linear in the light radiance: grad . radiance == loss."""
    arrays, static = compile_port(scenes.cornell_box(width=10, height=10, spp=2, max_depth=3))

    def loss(rad):
        return render_t.render(dataclasses.replace(arrays, light_radiance=rad), static, spp=2,
                               device="cpu").mean()

    base = arrays.light_radiance
    g = _grad(loss, base)
    with torch.no_grad():
        l1 = float(loss(base))
    np.testing.assert_allclose(float((g * base).sum()), l1, rtol=1e-4)


def test_grad_texels_flow():
    """Texture gradients reach the texel pool."""
    tex = DJ.ImageTexture(data=np.full((8, 8, 3), 0.5, np.float32), colorspace="linear")
    arrays, static = compile_port(scenes.cornell_box(
        width=10, height=10, spp=2, max_depth=2, wall_bsdf=DJ.Lambertian(albedo=tex)))

    def loss(texels):
        textures = dataclasses.replace(arrays.textures, texels=texels)
        return render_t.render(dataclasses.replace(arrays, textures=textures), static, spp=2,
                               device="cpu").mean()

    g = _grad(loss, arrays.textures.texels).numpy()
    assert np.isfinite(g).all()
    assert (np.abs(g) > 0).any()


FD_CASES = [
    # (bsdf, MaterialTable field, rel tolerance): tests/test_grad.py's matrix
    ("diffuse", DJ.Diffuse((0.6, 0.5, 0.4)), "base_color", 2e-3),
    ("lambertian", DJ.Lambertian(albedo=DJ.ConstantTexture((0.5, 0.6, 0.7))), "base_color", 2e-3),
    ("dielectric", DJ.Dielectric(), "int_ior", 5e-2),
    ("normalmap", DJ.NormalMap(nested=DJ.Diffuse((0.7, 0.6, 0.5)),
                               normals=DJ.ConstantTexture((0.5, 0.5, 1.0))), "base_color", 2e-3),
    ("ggx", DJ.GGX(albedo=DJ.ConstantTexture((0.6, 0.6, 0.6)), roughness=0.4), "roughness", 1e-2),
    ("roughconductor", DJ.RoughConductor(material="Cu", alpha=0.3), "alpha", 1e-2),
    ("roughplastic", DJ.RoughPlastic(alpha=0.3, kd=(0.5, 0.4, 0.3)), "base_color", 5e-2),
    ("roughdielectric", DJ.RoughDielectric(roughness=0.35), "alpha", 5e-2),
    ("kiss", DJ.KazenStandard(base_color=DJ.ConstantTexture((0.7, 0.5, 0.3)),
                              roughness=DJ.ConstantTexture((0.4,) * 3)), "base_color", 2e-3),
]


@pytest.mark.parametrize("name,bsdf,field,tol", FD_CASES, ids=[c[0] for c in FD_CASES])
def test_grad_fd_matrix_all_bsdfs(name, bsdf, field, tol):
    """FD against AD for every BSDF type: central differences of the whole
    field (tests/test_grad.py:test_grad_fd_matrix_all_bsdfs, case by
    case)."""
    loss, base = _loss_for(
        scenes.cornell_box(width=8, height=8, spp=1, max_depth=2, wall_bsdf=bsdf), field, spp=1)
    g = _grad(loss, base)
    h = 1e-3
    fd = _fd(loss, base, torch.full_like(base, h), h)
    ad = float(g.sum())
    assert abs(fd - ad) <= tol * max(abs(fd), abs(ad), 1e-4), (name, fd, ad)


def test_grad_fd_mirror_light_radiance():
    """The mirror has no continuous parameter: the gradient with respect to
    the light radiance through the specular chain equals FD (linear)."""
    arrays, static = compile_port(
        scenes.cornell_box(width=8, height=8, spp=1, max_depth=3, wall_bsdf=DJ.Mirror()))

    def lloss(rad):
        return render_t.render(dataclasses.replace(arrays, light_radiance=rad), static, spp=1,
                               device="cpu").mean()

    rad0 = arrays.light_radiance
    g = _grad(lloss, rad0)
    fd = _fd(lloss, rad0, torch.full_like(rad0, 1e-2), 1e-2)
    ad = float(g.sum())
    assert abs(fd - ad) <= 2e-3 * max(abs(fd), abs(ad), 1e-4), (fd, ad)


# ---------------------------------------------------------------------------
# the port's gradients against kazen_tpu's
# ---------------------------------------------------------------------------


def _parity_scene(name):
    if name == "multi_cluster":
        desc = multi_cluster_scene(width=16, height=16)
        # a constant background, so that escaping paths reach bg_color
        return dataclasses.replace(
            desc, background=DJ.Background(texture=DJ.ConstantTexture((0.3, 0.4, 0.5))))
    # the reference's gradient of a mip-filtered, importance-sampled sky
    # takes minutes to compile; the textures' own gradients need neither
    desc = textured_scene(width=12, height=12, sampler="independent", spp=1, max_depth=2,
                          importance=False, composite=False)
    return dataclasses.replace(desc, mip_textures=False)


@pytest.mark.parametrize("name", ["multi_cluster", "textured"])
def test_grads_match_reference(name):
    """d mean((img - target)^2) with respect to every material float field,
    the texels, the light radiance and the background colour, port against
    kazen_tpu on one compiled scene: allclose(rtol=1e-3, atol=1e-3 *
    max|g_ref|) per field."""
    a_j, s_j = compile_reference(_parity_scene(name))
    a_t, s_t = port_from_reference(a_j, s_j)
    target = (0.3 * np.random.default_rng(0).random((s_j.height, s_j.width, 3))).astype(np.float32)
    params_j = {"materials": mfp_j(a_j.materials), "texels": a_j.textures.texels,
                "light_radiance": a_j.light_radiance, "bg_color": a_j.bg_color}

    def loss_j(p):
        return jnp.mean((render_j(apply_j(a_j, p), s_j, spp=1) - target) ** 2)

    l_j, g_j = jax.value_and_grad(loss_j)(params_j)
    params_t = inv.as_leaves(inv.get_params(a_t, inv.PARAM_KEYS))
    img = inv.render_image(a_t, s_t, render_t.sampler_spec(s_t, "cpu"), params_t, [0])
    l_t = inv.image_loss(img, torch.from_numpy(target))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-4)
    got = {k: (None if t.grad is None else t.grad.numpy())
           for k, t in params_t["materials"].items()}
    assert_grads_close(got, {k: np.asarray(v) for k, v in g_j["materials"].items()}, name)
    for k in ("texels", "light_radiance", "bg_color"):
        assert_grads_close({k: params_t[k].grad}, {k: np.asarray(g_j[k])}, name)
    nonzero = {"multi_cluster": ("base_color", "roughness", "light_radiance", "bg_color"),
               "textured": ("base_color", "alpha", "texels", "light_radiance")}[name]
    for k in nonzero:
        g = g_j["materials"][k] if k in g_j["materials"] else g_j[k]
        assert float(jnp.abs(g).max()) > 0.0, k


def test_megakernel_scene_takes_the_wavefront_gradient():
    """A scene compiled with the megakernel on (its tables packed at compile
    time, where a swapped-in parameter would not reach them) gives optimize
    the wavefront's gradient: the same step as the scene compiled with it
    off, and a nonzero one."""
    desc = to_port(scenes.cornell_box(width=12, height=12, spp=2, max_depth=3))
    a_m, s_m = comp_t.compile_scene(desc, device="cpu", megakernel=True)
    a_w, s_w = comp_t.compile_scene(desc, device="cpu", megakernel=False)
    assert s_m.use_megakernel and not s_w.use_megakernel
    target = torch.zeros((12, 12, 3))
    grads = []
    for a, s in ((a_m, s_m), (a_w, s_w)):
        p = inv.as_leaves(inv.get_params(a, ("materials",)))
        inv.image_loss(inv.render_image(a, s, render_t.sampler_spec(s, "cpu"), p, [0]),
                       target).backward()
        grads.append(p["materials"]["base_color"].grad)
    assert torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0.0
    r_m = inv.optimize(a_m, s_m, target, steps=1, learning_rate=0.05)
    r_w = inv.optimize(a_w, s_w, target, steps=1, learning_rate=0.05)
    assert torch.equal(r_m.params["materials"]["base_color"], r_w.params["materials"]["base_color"])
    moved = r_m.params["materials"]["base_color"] != a_m.materials.base_color
    assert bool(moved[:5].all())  # every lit wall's albedo took a step
