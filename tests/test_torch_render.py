"""The slice as a whole: kazen_tpu_torch's path_mis pass against kazen_tpu's
at equal (sampler, spp, seed), on the CPU, where the port's trace runs its
plain versions and kazen_tpu's its shim.

Tolerances: per-lane radiance within rtol 1e-3 / atol 1e-4 on >= 99% of
lanes, channel means within 0.5%, rays traced within 0.1%. The two
frameworks differ in the last bits of transcendentals, so a discrete choice
taken at a threshold (Russian roulette, a BSDF lobe pick, an occlusion edge)
may flip on a few lanes, which then follow another path.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.integrate import camera as cam_j
from kazen_tpu.integrate import path_mis as pm_j
from kazen_tpu.integrate import render as render_j
from kazen_tpu.core import rng as rng_j
from kazen_tpu.samplers import streams as streams_j
from kazen_tpu_torch.film import film as film_t
from kazen_tpu_torch.film import io as io_t
from kazen_tpu_torch.integrate import camera as cam_t
from kazen_tpu_torch.integrate import path_mis as pm_t
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.samplers import streams as streams_t

from torch_port_helpers import (
    compile_port,
    compile_reference,
    multi_cluster_scene,
    single_cluster_scene,
)

PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "kazen_tpu_torch")

CASES = {
    # (description, sample index)
    "independent": (lambda: multi_cluster_scene(width=24, height=24), 0),
    "stratified_visible_reg": (
        lambda: multi_cluster_scene(width=24, height=24, sampler="stratified", spp=4,
                                    visible_lights=True, regularization=True),
        2,
    ),
    "single_cluster": (lambda: single_cluster_scene(width=20, height=20), 0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, sample = CASES[request.param]
    desc = make()
    return request.param, compile_reference(desc), compile_port(desc), sample


def _grid(static):
    ys, xs = np.meshgrid(np.arange(static.height), np.arange(static.width), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _li_reference(arrays, static, sample):
    spec = render_j.sampler_spec(static)
    px, py = _grid(static)
    st = streams_j.init_stream(spec, px.astype(np.uint32), py.astype(np.uint32), sample)
    st, jitter = streams_j.next_pixel_2d(spec, st)
    ps = jnp.stack([jnp.asarray(px), jnp.asarray(py)], -1).astype(jnp.float32) + jitter
    st, ap = streams_j.next_2d(spec, st)
    rays = cam_j.sample_ray(arrays, static, ps, ap)
    _, li, nrays = pm_j.li_wavefront(arrays, static, spec, st, rays)
    return np.asarray(li), float(nrays)


def _li_port(scene, static, sample):
    spec = render_t.sampler_spec(static)
    px, py = render_t.pixel_grid(static, scene.device)
    st = streams_t.init_stream(spec, px, py, sample)
    st, jitter = streams_t.next_pixel_2d(spec, st)
    ps = torch.stack([px, py], -1).to(torch.float32) + jitter
    st, ap = streams_t.next_2d(spec, st)
    rays = cam_t.sample_ray(scene, static, ps, ap)
    _, li, nrays = pm_t.li_wavefront(scene, static, spec, st, rays)
    return li.numpy(), float(nrays)


def _assert_radiance_close(got, want):
    lanes = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert lanes.mean() >= 0.99, lanes.mean()
    mg, mw = got.reshape(-1, got.shape[-1]).mean(0), want.reshape(-1, want.shape[-1]).mean(0)
    np.testing.assert_allclose(mg, mw, rtol=5e-3)


def test_li_wavefront_matches_reference(case):
    name, (a_j, s_j), (a_t, s_t), sample = case
    assert pm_t._ordering_useful(a_t) == (name != "single_cluster")
    li_j, nr_j = _li_reference(a_j, s_j, sample)
    li_t, nr_t = _li_port(a_t, s_t, sample)
    assert li_j.mean() > 0.01
    _assert_radiance_close(li_t, li_j)
    assert abs(nr_t - nr_j) <= 1e-3 * nr_j, (nr_t, nr_j)


def test_render_pass_film_matches_reference(case):
    name, (a_j, s_j), (a_t, s_t), sample = case
    spec_j = render_j.sampler_spec(s_j)
    px, py = _grid(s_j)
    a, c = rng_j.advance_constants(sample * 65536)
    jump = ((jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF)),
            (jnp.uint32(c >> 32), jnp.uint32(c & 0xFFFFFFFF)))
    film_j, nr_j = render_j._render_pass(
        a_j, s_j, spec_j, jnp.zeros((s_j.height, s_j.width, 4), jnp.float32),
        jnp.asarray(px.astype(np.uint32)), jnp.asarray(py.astype(np.uint32)),
        jnp.uint32(sample), jump,
    )
    pxt, pyt = render_t.pixel_grid(s_t, a_t.device)
    film_t_, nr_t = render_t._render_pass(
        a_t, s_t, render_t.sampler_spec(s_t), film_t.make_film(s_t, a_t.device), pxt, pyt,
        sample, rng_j.advance_constants(sample * 65536),
    )
    _assert_radiance_close(film_t_.numpy(), np.asarray(film_j))
    assert abs(float(nr_t) - float(nr_j)) <= 1e-3 * float(nr_j)


def test_render_entry_point(tmp_path):
    """render() on the CPU when asked; the default device is CUDA, and a
    scene compiled for the CPU is refused there."""
    a_t, s_t = compile_port(single_cluster_scene(width=8, height=6))
    img = render_t.render(a_t, s_t, spp=1, device="cpu")
    assert img.shape == (6, 8, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0.0
    io_t.save_png(str(tmp_path / "out.png"), img)
    with open(tmp_path / "out.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            render_t.render(a_t, s_t, spp=1)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            render_t.render(a_t, s_t, spp=1)


@pytest.mark.parametrize("kind", ["gaussian", "mitchell", "tent", "box"])
def test_filters_match_reference(kind):
    from types import SimpleNamespace

    from kazen_tpu.film import film as film_j

    static = SimpleNamespace(rfilter_kind=kind, rfilter_radius=2.0, rfilter_stddev=0.5,
                             rfilter_b=1.0 / 3.0, rfilter_c=1.0 / 3.0)
    x = np.linspace(-2.5, 2.5, 101).astype(np.float32)
    np.testing.assert_allclose(
        film_t.filter_eval(static, torch.from_numpy(x)).numpy(),
        np.asarray(film_j.filter_eval(static, jnp.asarray(x))), rtol=1e-6, atol=1e-7,
    )


def test_port_imports_neither_jax_nor_kazen_tpu():
    """Every module of kazen_tpu_torch, parsed: no import of jax (or
    jaxlib) and none of kazen_tpu. (A sys.modules check cannot work here:
    this interpreter imports jax at startup.)"""
    seen = set()
    for root, _, files in os.walk(PORT_DIR):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""] if node.level == 0 else []
                else:
                    continue
                for name in names:
                    top = name.split(".")[0]
                    assert not top.startswith("jax"), (path, name)
                    assert top != "kazen_tpu", (path, name)
            seen.add(os.path.relpath(path, PORT_DIR))
    assert len(seen) >= 30
    for module in (
        "samplers/tables.py", "integrate/staged.py", "integrate/simple.py", "core/dpdf.py",
        "shade/medium.py", "utils/metrics.py", "shade/textures.py", "shade/lights.py",
        "diff/inverse.py", "film/checkpoint.py", "scene/obj.py", "scene/xml_io.py",
        "dist/sharding.py", "dist/multihost.py", "cli/main.py", "cli/__main__.py",
        "lab/profile_pass2.py", "lab/glue_lab.py", "examples/baseline_configs.py",
        "lab/megakernel_cliff.py", "lab/kernel_ablate.py",
    ):
        assert module in seen, module
    # the pmj02bn tables are the port's own copy, not read from kazen_tpu
    from kazen_tpu_torch.samplers import tables as tables_t

    assert os.path.dirname(tables_t._CACHE) == os.path.join(PORT_DIR, "samplers")
