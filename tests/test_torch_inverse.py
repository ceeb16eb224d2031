"""Inverse rendering on the port: the recoveries of tests/test_inverse.py
(same scenes, steps and criteria) run through kazen_tpu_torch's optimize,
and one Adam step held against optax's."""
import dataclasses

import numpy as np
import optax
import pytest
import jax.numpy as jnp
import torch

import scenes
from kazen_tpu.scene import description as DJ
from kazen_tpu_torch.diff import inverse as inv
from kazen_tpu_torch.integrate import render as render_t

from torch_port_helpers import compile_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small renders gain nothing from intra-op threads (the file
    takes as long with one); one thread keeps them from contending with the
    suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replace(arrays, **kw):
    return dataclasses.replace(arrays, **kw)


def test_recover_albedo():
    """Recover the back wall's diffuse albedo from a rendered target."""
    arrays, static = compile_port(scenes.cornell_box(width=16, height=16, spp=8, max_depth=3))
    true_albedo = torch.tensor([0.2, 0.6, 0.8])
    base = arrays.materials.base_color.clone()
    base[2] = true_albedo  # the back wall is mesh 2 -> material 2
    target = render_t.render(
        _replace(arrays, materials=dataclasses.replace(arrays.materials, base_color=base)),
        static, spp=8, device="cpu")
    res = inv.optimize(arrays, static, target, param_keys=("materials",), steps=120,
                       learning_rate=0.05, spp_per_step=2)
    got = res.params["materials"]["base_color"][2].numpy()
    assert res.losses[-1] < res.losses[0] * 0.35, res.losses[[0, -1]]
    np.testing.assert_allclose(got, true_albedo.numpy(), atol=0.08)


def test_recover_light_intensity():
    arrays, static = compile_port(scenes.cornell_box(width=12, height=12, spp=4, max_depth=3))
    target = render_t.render(_replace(arrays, light_radiance=arrays.light_radiance * 0.5),
                             static, spp=4, device="cpu")
    res = inv.optimize(arrays, static, target, param_keys=("light_radiance",), steps=80,
                       learning_rate=0.4, spp_per_step=2, clip_to_unit=False)
    np.testing.assert_allclose(res.params["light_radiance"].numpy(),
                               arrays.light_radiance.numpy() * 0.5, rtol=0.12)


def test_recover_background_color():
    """A constant environment radiance through escape rays, each step at
    the target's sample indices."""
    arrays, static = compile_port(scenes.cornell_box(
        width=12, height=12, spp=4, max_depth=3,
        background=DJ.Background(texture=DJ.ConstantTexture((0.8, 0.4, 0.1)))))
    target = render_t.render(arrays, static, spp=4, device="cpu")
    start = _replace(arrays, bg_color=torch.tensor([0.3, 0.3, 0.3]))
    res = inv.optimize(start, static, target, param_keys=("bg_color",), steps=80,
                       learning_rate=0.1, spp_per_step=4, clip_to_unit=False)
    np.testing.assert_allclose(res.params["bg_color"].numpy(), [0.8, 0.4, 0.1], atol=0.05)


def test_recover_texture_map_through_trace_path():
    """An 8x8 image texture recovered texel by texel from flat gray (the
    port always runs the trace-tables path, so gradients flow through
    prepare_from_rows' closed-form recompute)."""
    rng = np.random.default_rng(7)
    true_tex = (0.25 + 0.6 * rng.random((8, 8, 3))).astype(np.float32)
    arrays, static = compile_port(scenes.cornell_box(
        width=24, height=24, spp=4, max_depth=2,
        wall_bsdf=DJ.Lambertian(albedo=DJ.ImageTexture(data=true_tex, colorspace="linear"))))
    target = render_t.render(arrays, static, spp=4, device="cpu")
    gray = dataclasses.replace(arrays.textures, texels=torch.full_like(arrays.textures.texels, 0.5))
    start = _replace(arrays, textures=gray)
    res = inv.optimize(start, static, target, param_keys=("texels",), steps=100,
                       learning_rate=0.08, spp_per_step=4)
    assert res.losses[-1] < res.losses[0] * 0.2, res.losses[[0, -1]]
    err0 = float((gray.texels - arrays.textures.texels).abs().mean())
    err1 = float((res.params["texels"] - arrays.textures.texels).abs().mean())
    assert err1 < 0.5 * err0, (err0, err1)


def test_recover_env_tint_through_trace_path():
    arrays, static = compile_port(scenes.cornell_box(
        width=12, height=12, spp=4, max_depth=3,
        background=DJ.Background(texture=DJ.ConstantTexture((0.7, 0.3, 0.15)))))
    target = render_t.render(arrays, static, spp=4, device="cpu")
    start = _replace(arrays, bg_color=torch.tensor([0.4, 0.4, 0.4]))
    res = inv.optimize(start, static, target, param_keys=("bg_color",), steps=80,
                       learning_rate=0.1, spp_per_step=4, clip_to_unit=False)
    np.testing.assert_allclose(res.params["bg_color"].numpy(), [0.7, 0.3, 0.15], atol=0.05)


def test_one_adam_step_matches_optax():
    """One optimize step equals optax.adam (learning rate, b1 0.9, b2 0.999,
    eps 1e-8) applied to the same gradient, then the clip to [0, 1], within
    rtol 1e-5; the step renders sample indices 0 and 1."""
    arrays, static = compile_port(scenes.cornell_box(width=10, height=10, spp=4, max_depth=2))
    target = torch.from_numpy(
        (0.5 * np.random.default_rng(1).random((10, 10, 3))).astype(np.float32))
    lr = 0.05
    keys = ("materials", "light_radiance")
    res = inv.optimize(arrays, static, target, param_keys=keys, steps=1, learning_rate=lr,
                       spp_per_step=2)
    assert inv.step_samples(0, 2, 4) == [0, 1] and inv.step_samples(3, 2, 4) == [2, 3]
    p = inv.as_leaves(inv.get_params(arrays, keys))
    img = inv.render_image(arrays, static, render_t.sampler_spec(static, "cpu"), p, [0, 1])
    loss = inv.image_loss(img, target)
    loss.backward()
    np.testing.assert_allclose(res.losses[0], float(loss.detach()), rtol=1e-6)

    def j(t):
        return jnp.asarray(t.detach().numpy())

    params_j = {"materials": {k: j(v) for k, v in p["materials"].items()},
                "light_radiance": j(p["light_radiance"])}
    grads_j = {"materials": {k: j(v.grad if v.grad is not None else torch.zeros_like(v))
                             for k, v in p["materials"].items()},
               "light_radiance": j(p["light_radiance"].grad)}
    opt = optax.adam(lr)
    updates, _ = opt.update(grads_j, opt.init(params_j), params_j)
    want = optax.apply_updates(params_j, updates)
    for k in ("base_color", "metallic", "roughness"):
        want["materials"][k] = jnp.clip(want["materials"][k], 0.0, 1.0)
    assert float(jnp.abs(grads_j["materials"]["base_color"]).max()) > 0.0
    for k, v in want["materials"].items():
        np.testing.assert_allclose(res.params["materials"][k].numpy(), np.asarray(v),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(res.params["light_radiance"].numpy(),
                               np.asarray(want["light_radiance"]), rtol=1e-5)
