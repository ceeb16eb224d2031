"""Wavefront NEE+MIS path tracer (PathMisIntegrator::Li,
integrator.cpp:195-338) as a masked lane batch.

The port of ``kazen_tpu/integrate/path_mis.py``. Every lane carries (ray,
throughput, eta, bsdf pdf, accumulated roughness, alive) and all lanes
advance through the same stages per bounce, so each lane draws its random
numbers exactly as the reference does and images agree at equal (sampler,
spp, seed):

  1. emitter hit ends the lane, with its MIS weight     (integrator.cpp:226-231)
  2. Russian roulette from depth 3, ``<=`` compare        (:237-244)
  3. NEE: uniform pick over the lights (and the environment,
     where it is importance-sampled), light sample, shadow
     ray that faces of primary-invisible lights never block (:247-294)
  4. roughness-bias accumulation (opt-in)                (:297-301)
  5. BSDF sample; throughput/eta update                  (:303-309)
  6. trace; miss -> background, MIS-weighted against the
     environment sampler where there is one              (:312-331)

Textured materials see the hit's mip footprint (``_texture_footprint``).

Ordered wavefront: after the primary trace (pixel order), the whole lane
state is permuted once per bounce into a shared packet order (picked light |
direction octant | hit cluster | direction Morton) that serves both the
shadow and the path trace; results go back to pixel order at the end. On the
card this keeps the rays of a warp coherent in the trace kernels. Each lane's
result does not depend on the order.

Stages 1-5 of a bounce are its shade stage: one CUDA kernel
(shade/bounce_kernel.py) for CUDA tensors of a scene in the kernel's class
outside autograd, else ``_shade_plain`` in plain PyTorch, with the same
bits. The bounce's uniforms are drawn at its head, in the reference's
order, for both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel import cluster_trace as ct
from ..accel.intersect import Rays
from ..core import math as km
from ..samplers import streams
from ..shade import bounce_kernel
from ..shade import bsdf as bsdf_mod
from ..shade import lights as lights_mod
from ..shade import textures as textures_mod
from ..shade.interaction import Interaction, prepare_from_rows
from ..utils import metrics

EPSILON = 1e-4  # Ray3f default mint (define.h)
INF = 3.0e38
_SENTINEL = 0xFFFFFFFF  # sort key of lanes with nothing left to trace


def _spread10(x):
    """Spread the low 10 bits of x two apart (Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton3(cell):
    return (_spread10(cell[:, 0]) << 2) | (_spread10(cell[:, 1]) << 1) | _spread10(cell[:, 2])


def _dmorton(d):
    """12-bit direction Morton code (16^3 cells); the top 3 bits are the
    direction octant. Non-finite directions land in some cell (the key only
    orders lanes)."""
    dcell = torch.clamp((d * 0.5 + 0.5) * 16.0, 0.0, 15.0).to(torch.int64) & 15
    return _morton3(dcell)


def power_heuristic(pdf_a, pdf_b):
    """powerHeuristic (integrator.cpp:340-344)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    ok = a2 > 0.0
    return torch.where(ok, a2 / torch.where(ok, a2 + b2, 1.0), 0.0)


def _detached(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def _trace_rows(scene, rays: Rays) -> torch.Tensor:
    """Nearest-hit trace: the (40, N) rows of accel/cluster_trace.py. The
    trace runs on gradient-stopped rays, as the reference's does: its rows
    are constants, and prepare_from_rows recomputes (t, u, v) from the rays
    that carry the gradient."""
    return ct.trace(scene.trace_tables, *map(_detached, rays))


def _occluded(scene, o, d, mint, maxt, active) -> torch.Tensor:
    """Shadow query in one any-hit pass that faces of primary-invisible
    lights never block (the single-pass form of integrator.cpp:259-278), on
    gradient-stopped rays."""
    return ct.occluded(scene.trace_tables, *map(_detached, (o, d, mint, maxt))) & active


def intersect(scene, rays: Rays):
    """Scene::rayIntersect: the nearest hit (a Hit), through the trace
    kernel K1 (its plain version on the CPU)."""
    return prepare_from_rows(rays, _trace_rows(scene, rays))[0]


def _ordering_useful(scene) -> bool:
    """Is the per-bounce coherence permute worth anything? Not for a
    single-cluster scene: every ray tests the one cluster whatever the
    order."""
    return scene.trace_tables.num_clusters > 1


class _OState(NamedTuple):
    """Wavefront state, in the lane order of the last path trace."""

    stream: streams.StreamState
    ray_o: torch.Tensor  # (N, 3) rays that produced `rows`
    ray_d: torch.Tensor  # (N, 3)
    rows: torch.Tensor  # (40, N) trace rows in the current order
    li: torch.Tensor  # (N, 3)
    throughput: torch.Tensor  # (N, 3)
    eta: torch.Tensor  # (N,)
    bsdf_pdf: torch.Tensor  # (N,) pdf of the BSDF sample that made ray_d
    discrete: torch.Tensor  # (N,) bool: that sample was a delta lobe
    accum_rough: torch.Tensor  # (N,)
    alive: torch.Tensor  # (N,) bool (not yet masked by the rows' validity)
    lane: torch.Tensor  # (N,) int64 pixel-order lane id
    rays: torch.Tensor  # () f32: useful rays traced


_MAX_ANISO = 16.0  # footprint elongation cap (OIIO's default anisotropy limit)


def _texture_footprint(static, its: Interaction, ray_d):
    """EWA-style two-axis texture footprint (what OIIO's anisotropic
    filtering gives the reference, texture.cpp:46-64).

    The pixel cone meets the surface as an ellipse: its minor diameter is
    |t| * pixel_cone, its major axis that stretched by 1/cos(theta) (capped
    at _MAX_ANISO) along the view direction's tangential part. Both axes are
    pulled back to uv space through the [dpdu dpdv] Jacobian (a 2x2 Gram
    solve); the mip level comes from the minor uv extent, and the lookup
    averages probes along the major uv half-axis (textures._eval_leaf).
    Degenerate footprints (view along the normal, singular Jacobian) take
    the isotropic extent over min(|dpdu|, |dpdv|).

    Returns (lod, (maj_du, maj_dv)), (lod, None) without anisotropy, or
    (None, None) when mip filtering is off or no material field is textured
    (textures.textured): material lookups alone read this footprint, and
    the background computes its own (lights.background_radiance)."""
    if not (static.mip_textures and textures_mod.textured(static)):
        return None, None
    # miss lanes carry t = 3e38: clamped to 1e8, far beyond any real
    # footprint, so that no product below overflows and the masked lanes'
    # texture probes stay finite
    foot = torch.clamp(torch.abs(its.t), max=1e8) * static.pixel_cone
    iso_len = foot / torch.clamp(
        torch.minimum(km.norm(its.dpdu), km.norm(its.dpdv)), min=1e-6
    )
    if not static.aniso_textures:
        return torch.log2(torch.clamp(iso_len, min=1e-9)), None
    nrm = its.sh_frame.n
    dn = (ray_d * nrm).sum(-1)
    cosv = torch.clamp(torch.abs(dn), 1.0 / _MAX_ANISO, 1.0)
    tang = ray_d - dn[..., None] * nrm
    tl = km.norm(tang)
    m_dir = tang / torch.clamp(tl, min=1e-9)[..., None]
    mi_dir = km.cross(nrm, m_dir)
    e = (its.dpdu * its.dpdu).sum(-1)
    fg = (its.dpdu * its.dpdv).sum(-1)
    g = (its.dpdv * its.dpdv).sum(-1)
    det = e * g - fg * fg
    ok = (det > 1e-16) & (tl > 1e-5)
    det_s = torch.where(ok, det, 1.0)

    def uv_vec(wvec):
        b1 = (wvec * its.dpdu).sum(-1)
        b2 = (wvec * its.dpdv).sum(-1)
        return (g * b1 - fg * b2) / det_s, (e * b2 - fg * b1) / det_s

    half = 0.5 * foot
    mdu, mdv = uv_vec(m_dir * (half / cosv)[..., None])
    idu, idv = uv_vec(mi_dir * half[..., None])
    minor_len = 2.0 * torch.sqrt(torch.clamp(idu * idu + idv * idv, min=1e-30))
    lod = torch.log2(torch.clamp(torch.where(ok, minor_len, iso_len), min=1e-9))
    return lod, (torch.where(ok, mdu, 0.0), torch.where(ok, mdv, 0.0))


def _light_eval_at_hit(scene, its: Interaction, ray_o):
    """Light::eval with lRec(ref=ray.o, p=its.p, n=its.shFrame.n)."""
    wi = km.normalize(its.p - ray_o)
    lidx = torch.clamp(its.light, min=0)
    return lights_mod.eval_area_light(scene, lidx, its.sh_frame.n, wi)


def _light_pdf_at_hit(scene, its: Interaction, ray_o):
    to_p = its.p - ray_o
    dist = km.norm(to_p)
    wi = to_p / torch.clamp(dist, min=1e-9)[:, None]
    lidx = torch.clamp(its.light, min=0)
    return lights_mod.pdf_area_light(scene, lidx, its.sh_frame.n, wi, dist)


@metrics.traced("shading")
def _shade_prologue(scene, static, st: _OState):
    """Bookkeeping for the trace that produced ``st.rows``
    (integrator.cpp:312-331): miss -> background (MIS-weighted against the
    environment sampler where it samples), alive &= valid."""
    valid = st.rows[3] >= 0.0
    missed = st.alive & ~valid
    bg = lights_mod.background_radiance(scene, static, st.ray_d)
    add = st.throughput * bg
    if bounce_kernel.env_nee(static):
        w_bg = power_heuristic(st.bsdf_pdf, lights_mod.pdf_env_dir(scene, static, st.ray_d))
        add = add * torch.where(st.discrete, 1.0, w_bg)[:, None]
    li = st.li + torch.where(missed[:, None], add, 0.0)
    return li, st.alive & valid


@metrics.traced("permute")
def packet_key(pick, cluster, d, alive, smaxt):
    """The shared packet order's sort key: picked light | path-direction
    octant | hit cluster | direction Morton. Lanes whose path ray continues
    sort before shadow-only lanes (the alive-first tier bit), and lanes with
    nothing to trace sort last."""
    md = _dmorton(d)
    key = (
        (torch.clamp(pick, max=15) << 26)
        | ((md >> 9) << 23)
        | (torch.clamp(cluster, 0, 16383) << 9)
        | (md & 0x1FF)
    )
    key = torch.where(alive, key, key | (1 << 30))
    return torch.where(alive | (smaxt >= 0.0), key, _SENTINEL)


@metrics.traced("permute")
def _packet_permute(key, columns, stream, lane):
    """The ordered permute: a stable argsort of ``key``, then one (N, 24)
    gather of the lane state's float ``columns`` and one (N, 7) gather of its
    stream and pixel-order lane id. Returns (floats, stream, lane)."""
    order = torch.argsort(key, stable=True)
    fl = (columns[0] if len(columns) == 1 else torch.cat(columns, dim=1))[order]
    ints = torch.stack([*stream, lane], dim=1)[order]
    return fl, streams.StreamState(*ints[:, :6].unbind(1)), ints[:, 6]


def _bounce_draws(spec, static, stream, draw_rr: bool):
    """The bounce's uniforms, all at its head, in the reference's order: RR
    (only when ``draw_rr``, reference depth >= 3), the light pick, triangle
    and warp pair (where there is something to pick), the BSDF's s1 and
    s2. No draw depends on lane state, so the streams advance as they did
    when each draw sat at its stage. Returns (stream, Draws)."""
    u_rr = u_pick = u_tri = u_a = u_b = None
    if draw_rr:
        stream, u_rr = streams.next_1d(spec, stream)
    if _nee_strata(static) > 0:
        stream, u_pick = streams.next_1d(spec, stream)
        stream, u_tri = streams.next_1d(spec, stream)
        stream, u_a = streams.next_1d(spec, stream)
        stream, u_b = streams.next_1d(spec, stream)
    stream, s1 = streams.next_1d(spec, stream)
    stream, s2 = streams.next_2d(spec, stream)
    return stream, bounce_kernel.Draws(u_rr, u_pick, u_tri, u_a, u_b, s1, s2)


def _nee_strata(static) -> int:
    """The NEE pick's strata: the lights, and the environment where it is
    importance-sampled."""
    return static.num_lights + int(bounce_kernel.env_nee(static))


def _hit_interaction(st: _OState) -> Interaction:
    """The shade prep of the hits in ``st.rows`` (prepare_from_rows)."""
    n = st.ray_o.shape[0]
    dev = st.ray_o.device
    return prepare_from_rows(
        Rays(
            o=st.ray_o, d=st.ray_d,
            mint=torch.zeros(n, device=dev), maxt=torch.full((n,), INF, device=dev),
        ),
        st.rows,
    )[1]


def _shade_plain(scene, static, st: _OState, li, alive, draws):
    """The shade stage of one bounce in plain PyTorch, from ``st.rows`` and
    the lane state after _shade_prologue (``li``, ``alive``) to the
    permute's columns (a bounce_kernel.ShadeOut): every material type's
    branch runs on every lane and ``torch.where`` keeps the lane's own. The
    kernel's contract and yardstick; CPU tensors, autograd calls and scenes
    outside the kernel's class take it."""
    n = st.ray_o.shape[0]
    dev = st.ray_o.device
    its = _hit_interaction(st)
    throughput = st.throughput
    eta = st.eta
    accum = st.accum_rough

    wi_local = its.sh_frame.to_local(-st.ray_d)
    lod, aniso = _texture_footprint(static, its, st.ray_d)
    ctx = bsdf_mod.make_ctx(
        static, scene, its.material, its.uv, its.sh_frame, wi_local, dpdu=its.dpdu,
        lod=lod, aniso=aniso,
    )

    # (1) emitter hit ends the lane (integrator.cpp:226-231); the MIS weight
    # comes from the carried (bsdf_pdf, discrete)
    hit_light = alive & (its.light >= 0)
    bw = torch.where(
        st.discrete,
        1.0,
        power_heuristic(st.bsdf_pdf, _light_pdf_at_hit(scene, its, st.ray_o)),
    )
    le = _light_eval_at_hit(scene, its, st.ray_o)
    li = li + torch.where(hit_light[:, None], bw[:, None] * throughput * le, 0.0)
    alive = alive & ~hit_light

    # (2) Russian roulette (integrator.cpp:237-244), from reference depth 3:
    # where the bounce drew its RR uniform
    if draws.u_rr is not None:
        u_rr = draws.u_rr
        prob = torch.clamp(throughput.amax(dim=-1) * eta * eta, max=0.95)
        alive = alive & ~(prob <= u_rr)
        rr_scale = torch.where(alive, 1.0 / torch.clamp(prob, min=1e-9), 1.0)
        throughput = throughput * rr_scale[:, None]

    # (3) NEE sampling (integrator.cpp:247-294); the occlusion query runs
    # after the permute, so the masked contribution rides the state. With
    # environment importance sampling the pick draws over num_lights + 1
    # strata, the last one the environment.
    do_env = bounce_kernel.env_nee(static)
    n_strat = _nee_strata(static)
    if n_strat > 0:
        u_pick, u_tri, u_a, u_b = draws.u_pick, draws.u_tri, draws.u_a, draws.u_b
        pick = lights_mod.select_uniform(n_strat, u_pick)
        if static.num_lights > 0:
            ls = lights_mod.sample_area_light(
                scene, torch.clamp(pick, 0, static.num_lights - 1), its.p, u_tri, u_a, u_b
            )
            nee_wi, nee_maxt = ls.wi, ls.dist - static.trace_bias
            nee_ls, nee_pdf = ls.ls, ls.pdf
        if do_env:
            env = lights_mod.sample_env_light(scene, static, u_a, u_b)
            if static.num_lights > 0:
                is_env = pick == static.num_lights
                nee_wi = torch.where(is_env[:, None], env.wi, nee_wi)
                nee_maxt = torch.where(is_env, INF, nee_maxt)
                nee_ls = torch.where(is_env[:, None], env.ls, nee_ls)
                nee_pdf = torch.where(is_env, env.pdf, nee_pdf)
            else:
                nee_wi, nee_ls, nee_pdf = env.wi, env.ls, env.pdf
                nee_maxt = torch.full_like(env.pdf, INF)
        wo_local = its.sh_frame.to_local(nee_wi)
        f, pdf_b = bsdf_mod.eval_pdf_ctx(static, ctx, wo_local, accum)
        w_light = power_heuristic(nee_pdf, pdf_b)
        contrib = torch.where(
            alive[:, None], throughput * (nee_ls * n_strat) * f * w_light[:, None], 0.0
        )
        # a lane whose NEE contribution is already zero needs no occlusion
        # answer: its shadow ray is marked dead (maxt < 0) and exits at the
        # root. Output and stream consumption are unchanged.
        shadow = alive & (contrib != 0.0).any(dim=-1)
        smaxt = torch.where(shadow, nee_maxt, -1.0)
        n_shadow_rays = shadow.sum(dtype=torch.float32)
    else:
        pick = torch.zeros(n, dtype=torch.int64, device=dev)
        nee_wi = st.ray_d
        contrib = torch.zeros((n, 3), device=dev)
        smaxt = torch.full((n,), -1.0, device=dev)
        n_shadow_rays = torch.zeros((), device=dev)

    # (4) roughness-bias firefly control (integrator.cpp:297-301)
    if static.regularization:
        reg = bsdf_mod.regularize_ctx(static, ctx)
        accum = torch.where(alive, accum + reg * static.accumulated_roughness, accum)

    # (5) BSDF sampling (integrator.cpp:303-309)
    res = bsdf_mod.sample_ctx(static, ctx, draws.s1, draws.s2, accum)
    throughput = torch.where(alive[:, None], throughput * res.weight, throughput)
    eta = torch.where(alive, eta * res.eta, eta)
    alive = alive & (res.weight > 0.0).any(dim=-1)
    return bounce_kernel.ShadeOut(
        p=its.p, nee_wi=nee_wi, smaxt=smaxt, pd=its.sh_frame.to_world(res.wo), li=li,
        throughput=throughput, eta=eta, accum=accum, contrib=contrib, bsdf_pdf=res.pdf,
        discrete=res.is_discrete, alive=alive, pick=pick, cluster=its.cluster,
        n_shadow_rays=n_shadow_rays, n_path_rays=alive.sum(dtype=torch.float32),
    )


def _shade(scene, static, st: _OState, li, alive, draws):
    """The shade stage by the route the scene and the call allow
    (bounce_kernel.route_reason): the kernel or _shade_plain. The tracer's
    ``shade_route`` counter counts the bounce by route, and a plain one by
    its reason; ``texture_footprint`` counts a plain bounce whose
    _texture_footprint returns a footprint, ``env_nee`` one whose NEE
    samples the environment, ``beckmann_lobes`` one of a scene with a
    rough* material (the kernel counts its own).
    Textured material fields hand the kernel the texel pool; it derives the
    hits' footprint itself."""
    route, reason = bounce_kernel.route_reason(
        scene, static,
        (st.ray_o, st.ray_d, li, st.throughput, st.eta, st.bsdf_pdf, st.accum_rough),
    )
    metrics.shade_route(route, reason)
    if route == "plain":
        if bounce_kernel.footprint_mode(static) > 0:
            metrics.texture_footprint("plain")
        if bounce_kernel.env_nee(static):
            metrics.env_nee("plain")
        if bounce_kernel.rough_lobes(static):
            metrics.beckmann_lobes("plain")
        return _shade_plain(scene, static, st, li, alive, draws)
    return bounce_kernel.shade_cuda(
        bounce_kernel.tables_for(scene), static, st.rows, st.ray_o, st.ray_d, li, alive,
        st.throughput, st.eta, st.bsdf_pdf, st.discrete, st.accum_rough, draws,
        texels=scene.textures.texels,
    )


def _bounce_ordered(scene, static, spec, st: _OState, draw_rr: bool) -> _OState:
    """One bounce. The bounce's uniforms are drawn first; the shade stage
    runs in the order of the trace that made ``st.rows``; then one permute
    moves rays and state into the next packet order, where the shadow and
    the path trace run. The RR draw is consumed only when ``draw_rr``
    (reference depth >= 3)."""
    n = st.ray_o.shape[0]
    dev = st.ray_o.device
    stream, draws = _bounce_draws(spec, static, st.stream, draw_rr)
    li, alive = _shade_prologue(scene, static, st)
    out = _shade(scene, static, st, li, alive, draws)
    p, nee_wi, smaxt, pd = out.p, out.nee_wi, out.smaxt, out.pd
    li, throughput, eta, accum = out.li, out.throughput, out.eta, out.accum
    contrib, bsdf_pdf, discrete, alive = out.contrib, out.bsdf_pdf, out.discrete, out.alive
    lane = st.lane

    if _ordering_useful(scene):
        key = packet_key(out.pick, out.cluster, pd, alive, smaxt)
        fl, stream, lane = _packet_permute(key, out.columns(), stream, lane)
        p, nee_wi, smaxt, pd = fl[:, 0:3], fl[:, 3:6], fl[:, 6], fl[:, 7:10]
        li, throughput, eta, accum = fl[:, 10:13], fl[:, 13:16], fl[:, 16], fl[:, 17]
        contrib, bsdf_pdf = fl[:, 18:21], fl[:, 21]
        discrete, alive = fl[:, 22] > 0.5, fl[:, 23] > 0.5

    # shadow trace, then path trace, in the shared order
    if _nee_strata(static) > 0:
        occluded = _occluded(
            scene, p, nee_wi, static.trace_bias, smaxt, smaxt >= 0.0
        )
        li = li + torch.where(occluded[:, None], 0.0, contrib)
    rays = Rays(
        o=p,
        d=pd,
        mint=torch.full((n,), static.trace_bias, device=dev),
        maxt=torch.where(alive, INF, -1.0),
    )
    return _OState(
        stream=stream,
        ray_o=p,
        ray_d=pd,
        rows=_trace_rows(scene, rays),
        li=li,
        throughput=throughput,
        eta=eta,
        bsdf_pdf=bsdf_pdf,
        discrete=discrete,
        accum_rough=accum,
        alive=alive,
        lane=lane,
        rays=st.rays + out.n_shadow_rays + out.n_path_rays,
    )


def wavefront_init(scene, static, spec, stream, rays: Rays) -> _OState:
    """Primary trace + punch-through recast + the initial state, in pixel
    lane order."""
    n = rays.o.shape[0]
    dev = rays.o.device
    rows = _trace_rows(scene, rays)

    # camera-ray punch-through of primary-invisible lights
    # (integrator.cpp:213-220): one re-cast past the light; if the re-cast
    # misses, the light hit is kept (reference behaviour)
    ray_o = rays.o
    if static.num_lights > 0:
        punch = (rows[3] >= 0.0) & (rows[28] >= 0.0) & (rows[29] < 0.5)
        _, its0 = prepare_from_rows(rays, rows)
        o2 = its0.p + static.trace_bias * rays.d
        rows2 = _trace_rows(
            scene,
            Rays(
                o=o2, d=rays.d, mint=torch.full((n,), EPSILON, device=dev),
                maxt=torch.where(punch, INF, -1.0),
            ),
        )
        take = punch & (rows2[3] >= 0.0)
        rows = torch.where(take[None, :], rows2, rows)
        ray_o = torch.where(take[:, None], o2, rays.o)

    return _OState(
        stream=stream,
        ray_o=ray_o,
        ray_d=rays.d,
        rows=rows,
        li=torch.zeros((n, 3), device=dev),
        throughput=torch.ones((n, 3), device=dev),
        eta=torch.ones(n, device=dev),
        bsdf_pdf=torch.zeros(n, device=dev),
        discrete=torch.ones(n, dtype=torch.bool, device=dev),  # camera "lobe"
        accum_rough=torch.zeros(n, device=dev),
        alive=rows[3] >= 0.0,
        lane=torch.arange(n, device=dev),
        rays=torch.full((), float(n), device=dev),
    )


def wavefront_finish(scene, static, st: _OState):
    """Final miss -> background and the way back to pixel lane order. The
    last trace's emitter hit lies beyond max_depth and adds nothing
    (reference loop-exit truncation). Returns (stream, li, nrays)."""
    li, _ = _shade_prologue(scene, static, st)
    inv = torch.argsort(st.lane)
    return st.stream.index(inv), li[inv], st.rays


def li_wavefront(scene, static, spec, stream, rays: Rays):
    """Integrator::Li over a lane batch: (stream, li (N, 3), rays traced)."""
    st = wavefront_init(scene, static, spec, stream, rays)
    for depth in range(static.max_depth):
        with metrics.span("shading", "depth", depth):
            st = _bounce_ordered(scene, static, spec, st, draw_rr=depth >= 3)
    return wavefront_finish(scene, static, st)
