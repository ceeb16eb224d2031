"""kazen_tpu_torch's megakernel path (integrate/megakernel.py) against
kazen_tpu's megakernel and against the port's own wavefront, on the CPU,
where the port runs the kernel's plain version and kazen_tpu its shim.

Limits, as for the wavefront (tests/test_torch_render.py): per-lane radiance
within rtol 1e-3 / atol 1e-4 on >= 99% of lanes and channel means within
0.5%; rays within 1.5 of each other, as kazen_tpu's own megakernel test
holds its two paths (tests/test_megakernel.py), except the wavefront against
kazen_tpu's wavefront (0.1%, as test_torch_render.py). A discrete choice at
a threshold (Russian roulette, a lobe pick, a shared edge) may flip on a few
lanes where the two sides round the last bit apart.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kazen_tpu.integrate import camera as cam_j
from kazen_tpu.integrate import megakernel as mk_j
from kazen_tpu.integrate import path_mis as pm_j
from kazen_tpu.integrate import render as render_j
from kazen_tpu.samplers import streams as streams_j
from kazen_tpu.scene import description as DJ
from kazen_tpu.scene.compiler import compile_scene as compile_jax
from kazen_tpu_torch.integrate import camera as cam_t
from kazen_tpu_torch.integrate import megakernel as mk_t
from kazen_tpu_torch.integrate import path_mis as pm_t
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.samplers import streams as streams_t
from kazen_tpu_torch.scene import compiler as comp_t

from _isolate import subprocess_isolated
from scenes import cornell_box
from torch_port_helpers import (
    compile_port,
    compile_reference,
    mixed_scene,
    multi_cluster_scene,
    port_from_reference,
    to_port,
)


def _lanes_port(scene, static, sample):
    """Sample pass ``sample``'s streams and camera rays, as render() makes them."""
    spec = render_t.sampler_spec(static)
    px, py = render_t.pixel_grid(static, scene.device)
    st = streams_t.init_stream(spec, px, py, sample)
    st, jitter = streams_t.next_pixel_2d(spec, st)
    ps = torch.stack([px, py], -1).to(torch.float32) + jitter
    st, ap = streams_t.next_2d(spec, st)
    return spec, st, cam_t.sample_ray(scene, static, ps, ap)


def _lanes_reference(arrays, static, sample):
    spec = render_j.sampler_spec(static)
    ys, xs = np.meshgrid(np.arange(static.height), np.arange(static.width), indexing="ij")
    px = jnp.asarray(xs.reshape(-1).astype(np.uint32))
    py = jnp.asarray(ys.reshape(-1).astype(np.uint32))
    st = streams_j.init_stream(spec, px, py, sample)
    st, jitter = streams_j.next_pixel_2d(spec, st)
    ps = jnp.stack([px, py], -1).astype(jnp.float32) + jitter
    st, ap = streams_j.next_2d(spec, st)
    return spec, st, cam_j.sample_ray(arrays, static, ps, ap)


def _assert_li_close(got, want, rays_got, rays_want, rays_tol):
    lanes = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    mg, mw = got.mean(0), want.mean(0)
    means = np.abs(mg - mw) / np.abs(mw)
    msg = (f"lanes within limits {lanes.mean():.5f}, max rel err {rel.max():.3g}, "
           f"channel means {mg} vs {mw}, rays {rays_got} vs {rays_want}")
    assert want.mean() > 0.01, msg
    assert lanes.mean() >= 0.99, msg
    assert means.max() <= 5e-3, msg
    assert abs(rays_got - rays_want) <= rays_tol, msg


def _unpack(rows, n):
    """The reference's 8-records-per-row table as (n, 16) records."""
    return np.asarray(rows).reshape(-1, 16)[:n]


def test_tables_match_reference():
    """The port's packed tables equal kazen_tpu's MegaTables record for
    record, from its own compile and from kazen_tpu's scene carried across;
    the static config is the reference's."""
    desc = mixed_scene()
    a_j, s_j = compile_reference(desc)
    a_t, s_t = compile_port(desc)
    a_r, s_r = port_from_reference(a_j, s_j)
    assert s_t.mega_cfg == s_j.mega_cfg == s_r.mega_cfg
    assert s_t.use_megakernel is s_j.use_megakernel is s_r.use_megakernel is False
    m_j, nf = a_j.mega, int(a_j.F.shape[0])
    assert nf == 22
    for t in (a_t.mega, a_r.mega):
        np.testing.assert_array_equal(t.geo.numpy(), _unpack(m_j.tris, nf))
        np.testing.assert_array_equal(t.attr.numpy(), _unpack(m_j.attr, nf))
        for name in ("mats", "light_tris", "light_cdf", "light_info"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(m_j, name)))
        assert t.background == tuple(np.asarray(m_j.consts)[0, :3].tolist())


@pytest.mark.parametrize("case", ["cornell", "pmj02bn", "many_faces", "light_tris"])
def test_supported_reason_matches_reference(case):
    """The scene class is the reference's: the Cornell box is in it; the
    pmj02bn sampler, more than 128 faces or 64 light triangles are not."""
    if case == "many_faces":
        desc = multi_cluster_scene(width=8, height=8)
    else:
        desc = cornell_box(width=8, height=8, sampler="pmj02bn" if case == "pmj02bn" else "independent")
    a_j, s_j = compile_jax(desc)
    a_t, s_t = compile_port(desc)
    if case == "light_tris":
        s_j = dataclasses.replace(s_j, num_lights=1)
        a_j = a_j._replace(light_faces=jnp.zeros((1, 65), jnp.int32))
        a_t = dataclasses.replace(a_t, light_faces=torch.zeros((1, 65), dtype=torch.int64))
    want = mk_j.supported_reason(a_j, s_j)
    assert mk_t.supported_reason(a_t, s_t) == want
    assert want[0] == (case == "cornell"), want
    if case == "cornell":
        assert not s_t.use_megakernel and not s_j.use_megakernel  # CPU default
        assert a_t.mega is not None


def test_compile_megakernel_argument():
    """``megakernel=True`` takes the route on the CPU too; ``False`` keeps
    the wavefront; True on a scene outside the class raises."""
    desc = to_port(cornell_box(width=8, height=8))
    _, s_on = comp_t.compile_scene(desc, device="cpu", megakernel=True)
    _, s_off = comp_t.compile_scene(desc, device="cpu", megakernel=False)
    assert s_on.use_megakernel and not s_off.use_megakernel
    assert s_on.mega_cfg == s_off.mega_cfg is not None
    assert render_t.li_fn_for(s_on) is mk_t.li_megakernel
    assert render_t.li_fn_for(s_off) is pm_t.li_wavefront
    big = to_port(multi_cluster_scene(width=8, height=8))
    with pytest.raises(ValueError, match="faces"):
        comp_t.compile_scene(big, device="cpu", megakernel=True)


@subprocess_isolated
def test_megakernel_plain_matches_reference():
    """megakernel_plain against kazen_tpu's li_megakernel (its shim) on the
    Cornell box at 16x16, independent sampler, sample index 3."""
    desc = cornell_box(width=16, height=16)
    a_j, s_j = compile_jax(desc)
    spec_j, st_j, rays_j = _lanes_reference(a_j, s_j, 3)
    _, li_j, nr_j = mk_j.li_megakernel(a_j, s_j, spec_j, st_j, rays_j, interpret="shim")
    a_t, s_t = compile_port(desc)
    spec_t, st_t, rays_t = _lanes_port(a_t, s_t, 3)
    _, li_t, nr_t = mk_t.li_megakernel(a_t, s_t, spec_t, st_t, rays_t)
    _assert_li_close(li_t.numpy(), np.asarray(li_j), float(nr_t), float(nr_j), 1.5)


def _reg_bg_scene(width, height):
    """Kiss walls with roughness regularization and a constant background
    (tests/test_megakernel.py's regularization case)."""
    return cornell_box(
        width=width, height=height, spp=1, regularization=True,
        wall_bsdf=DJ.KazenStandard(base_color=(0.6, 0.6, 0.6), roughness=0.4),
        background=DJ.Background(texture=DJ.ConstantTexture((0.2, 0.3, 0.4)), intensity=1.5),
    )


def _unlit_scene(width, height):
    """The same without its light: no NEE, the background lights it."""
    desc = _reg_bg_scene(width, height)
    return dataclasses.replace(desc, meshes=[m for m in desc.meshes if m.light is None])


# (scene description at (width, height), sample index): the mixed-material
# scene under each sampler, and the branches it leaves out
CASES = {
    "independent": (lambda w, h: mixed_scene(w, h), 0),
    "stratified": (lambda w, h: mixed_scene(w, h, "stratified", 4), 2),
    "correlated": (lambda w, h: mixed_scene(w, h, "correlated", 8), 1),
    "regularization_background": (_reg_bg_scene, 0),
    "no_lights": (_unlit_scene, 0),
}


@pytest.fixture(scope="module")
def mixed_port():
    return compile_port(mixed_scene())


@pytest.mark.parametrize("case", sorted(CASES))
def test_megakernel_matches_wavefront(case):
    """The port's two paths at 16x16 on the same streams and rays: the
    megakernel's plain version and li_wavefront, on the mixed-material scene
    (every BSDF branch) under each sampler, with regularization and a
    background, and without lights."""
    make, sample = CASES[case]
    scene, static = compile_port(make(16, 16))
    assert static.mega_cfg is not None
    spec, st, rays = _lanes_port(scene, static, sample)
    _, li_w, nr_w = pm_t.li_wavefront(scene, static, spec, st, rays)
    st_m, li_m, nr_m = mk_t.li_megakernel(scene, static, spec, st, rays)
    assert st_m is st
    _assert_li_close(li_m.numpy(), li_w.numpy(), float(nr_m), float(nr_w), 1.5)


def test_wavefront_mixed_matches_reference(mixed_port):
    """The port's wavefront on the mixed-material scene against kazen_tpu's:
    the four BSDFs of this slice held end to end."""
    desc = mixed_scene()
    a_j, s_j = compile_reference(desc)
    spec_j, st_j, rays_j = _lanes_reference(a_j, s_j, 0)
    _, li_j, nr_j = pm_j.li_wavefront(a_j, s_j, spec_j, st_j, rays_j)
    scene, static = mixed_port
    spec, st, rays = _lanes_port(scene, static, 0)
    _, li_t, nr_t = pm_t.li_wavefront(scene, static, spec, st, rays)
    _assert_li_close(li_t.numpy(), np.asarray(li_j), float(nr_t), float(nr_j), 1e-3 * float(nr_j))


def test_render_through_the_megakernel():
    """render() on a scene compiled with megakernel=True runs the plain
    version on the CPU and gives the wavefront's image."""
    desc = to_port(mixed_scene(width=12, height=8))
    imgs = []
    for flag in (True, False):
        scene, static = comp_t.compile_scene(desc, device="cpu", megakernel=flag)
        imgs.append(render_t.render(scene, static, spp=1, device="cpu").numpy())
    assert imgs[0].shape == (8, 12, 3) and np.isfinite(imgs[0]).all()
    lanes = np.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4).all(-1)
    assert lanes.mean() >= 0.99 and imgs[0].mean() > 0.0


def test_wrapper_routes_by_device(mixed_port):
    """CPU tensors take the plain version without a launch; the kernel
    wrapper refuses them."""
    scene, static = mixed_port
    spec, st, rays = _lanes_port(scene, static, 0)
    before = mk_t.MEGAKERNEL.launches
    out = mk_t.megakernel(scene.mega, static.mega_cfg, rays.o, rays.d, st)
    assert out.shape == (mk_t.OUT_ROWS, rays.o.shape[0])
    assert mk_t.MEGAKERNEL.launches == before
    cfg = dict(static.mega_cfg)
    assert (out[3] >= 1).all() and (out[4] >= cfg["F"]).all()
    assert (out[5] >= 0).all() and (out[5] <= cfg["max_depth"]).all()
    with pytest.raises(ValueError, match="CUDA"):
        mk_t.megakernel_cuda(scene.mega, static.mega_cfg, rays.o, rays.d, st)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_counts_work(case):
    """Rows 4 and 5 of the plain version at 16x16: F tests per nearest-hit
    trace and at most F per shadow ray (F x (rays - bounces) <= tests <= F x
    (rays + 1), the punch-through re-cast being the one trace that is not a
    ray), exactly F x rays without lights; 0 <= bounces <= max_depth, 0
    exactly where the camera ray missed."""
    make, sample = CASES[case]
    scene, static = compile_port(make(16, 16))
    _, st, rays = _lanes_port(scene, static, sample)
    cfg = dict(static.mega_cfg)
    F = cfg["F"]
    out = mk_t.megakernel_plain(scene.mega, cfg, rays.o, rays.d, st).double()
    nrays, tests, bounces = out[3], out[4], out[5]
    assert torch.equal(tests, tests.round()) and torch.equal(bounces, bounces.round())
    assert (F * (nrays - bounces) <= tests).all() and (tests <= F * (nrays + 1)).all()
    if cfg["L"] == 0:
        assert torch.equal(tests, F * nrays)
    else:
        assert (tests > F * (nrays - bounces)).any()  # shadow rays were counted
    assert (bounces >= 0).all() and (bounces <= cfg["max_depth"]).all()
    found = mk_t._trace(scene.mega, tuple(rays.o.unbind(-1)), tuple(rays.d.unbind(-1)), mk_t.EPS)[
        "found"
    ]
    assert torch.equal(bounces == 0, ~found) and bool(found.any())


def test_plain_shadow_tests_stop_at_first_blocker():
    """_occluded counts the faces that can block, in face order, up to and
    including the first that blocks: all of them on a free ray."""
    scene, static = compile_port(cornell_box(width=4, height=4))
    tables = scene.mega
    g = tables.geo
    can_block = ~((g[:, 10] >= 0.0) & (g[:, 11] == 0.0))
    # from the box's middle: straight down to the floor, and a ray with no
    # room to reach anything
    o = (torch.tensor([0.0, 0.0]), torch.tensor([1.0, 1.0]), torch.tensor([0.0, 0.0]))
    d = (torch.tensor([0.0, 0.0]), torch.tensor([-1.0, -1.0]), torch.tensor([0.0, 0.0]))
    blocked, tests = mk_t._occluded(tables, o, d, 1e-4, torch.tensor([5.0, 0.5]))
    t, _, _, ok = mk_t._face_test(tables, o, d)
    first = int(torch.nonzero(ok[0] & (t[0] >= 1e-4) & can_block)[0])
    assert blocked.tolist() == [True, False]
    assert tests.tolist() == [int(can_block[: first + 1].sum()), int(can_block.sum())]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K3 against its plain version on the card, every case at 32x32, both
    schedules: rows 0-5 equal on every lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the megakernel has no CPU mode")
    for make, sample in CASES.values():
        scene, static = comp_t.compile_scene(to_port(make(32, 32)), device="cuda")
        assert static.use_megakernel
        _, st, rays = _lanes_port(scene, static, sample)
        st = type(st)(*(f.contiguous() for f in st))
        o, d = rays.o.contiguous(), rays.d.contiguous()
        p = mk_t.megakernel_plain(scene.mega, static.mega_cfg, o, d, st)
        for refill in (0, 1):
            before = mk_t.MEGAKERNEL.launches
            k = mk_t.megakernel_cuda(scene.mega, static.mega_cfg, o, d, st, refill=refill)
            torch.cuda.synchronize()
            assert mk_t.MEGAKERNEL.launches == before + 1
            differ = int((k != p).any(0).sum())
            assert differ == 0, f"refill {refill}: {differ} lanes differ"


def test_image_background_takes_the_wavefront():
    """A scene of <= 128 faces under an image background (no importance
    sampling) stays off K3, which shades only a constant background, with
    the reference's reason; the background check itself, reached with the
    texture flags cleared, gives the reference's reason too."""
    sky = np.full((4, 8, 3), 0.3, np.float32)
    desc = cornell_box(width=8, height=8, background=DJ.Background(
        texture=DJ.ImageTexture(data=sky, colorspace="linear")))
    a_j, s_j = compile_jax(desc)
    a_t, s_t = compile_port(desc)
    assert int(a_t.F.shape[0]) <= mk_t.MAX_BRUTE and int(a_t.bg_tex) >= 0
    want = mk_j.supported_reason(a_j, s_j)
    assert mk_t.supported_reason(a_t, s_t) == want and not want[0]
    assert not s_t.use_megakernel and a_t.mega is None
    with pytest.raises(ValueError, match="class"):
        comp_t.compile_scene(to_port(desc), device="cpu", megakernel=True)
    s_j2 = dataclasses.replace(s_j, has_image_textures=False)
    s_t2 = dataclasses.replace(s_t, has_image_textures=False)
    want = mk_j.supported_reason(a_j, s_j2)
    assert want == (False, "image background texture")
    assert mk_t.supported_reason(a_t, s_t2) == want
