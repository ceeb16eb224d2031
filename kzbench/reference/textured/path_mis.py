"""The wavefront path tracer of the Textured configuration: ``con1/``'s
bounce with the importance-sampled environment as the last NEE stratum
(the port's ``path_mis._shade_plain`` step 3: a pick over num_lights + 1
strata, the environment's sample for the lanes that pick it, an unbounded
shadow ray) and the miss side's MIS weight against the environment sampler
(``_shade_prologue``), drawing from ``kz/``'s streams. Frozen copies of the
port's ``_shade_prologue`` and ``_nee_strata``; ``wavefront_finish`` is
``kz/``'s with this prologue; everything else is ``kz/``'s. ``kz.ROUND``
rounds the lane state between stages, as there: the control sets it.
"""
from __future__ import annotations

import torch

from ..kz.accel.intersect import Rays
from ..kz.integrate import path_mis as kz
from ..kz.integrate.path_mis import (
    INF,
    _light_eval_at_hit,
    _light_pdf_at_hit,
    _occluded,
    _OState,
    _texture_footprint,
    _trace_rows,
    power_heuristic,
    wavefront_init,
)
from ..kz.samplers import streams
from ..kz.shade import lights as kz_lights
from ..kz.shade.interaction import prepare_from_rows
from . import bsdf as bsdf_mod
from . import lights as lights_mod


def _env_nee(static) -> bool:
    return bool(static.env_importance and static.has_background)


def _nee_strata(static) -> int:
    """The NEE pick's strata: the lights, and the environment where it is
    importance-sampled."""
    return static.num_lights + int(_env_nee(static))


def _shade_prologue(scene, static, st: _OState):
    """Bookkeeping for the trace that produced ``st.rows``
    (integrator.cpp:312-331): miss -> background, MIS-weighted against the
    environment sampler where it samples; alive &= valid."""
    valid = st.rows[3] >= 0.0
    missed = st.alive & ~valid
    bg = kz_lights.background_radiance(scene, static, st.ray_d)
    add = st.throughput * bg
    if _env_nee(static):
        w_bg = power_heuristic(st.bsdf_pdf, lights_mod.pdf_env_dir(scene, static, st.ray_d))
        add = add * torch.where(st.discrete, 1.0, w_bg)[:, None]
    li = st.li + torch.where(missed[:, None], add, 0.0)
    return li, st.alive & valid


def _bounce_ordered(scene, static, spec, st: _OState, draw_rr: bool) -> _OState:
    """One bounce, in the lanes' own order. The RR draw is consumed only
    when ``draw_rr`` (reference depth >= 3)."""
    n = st.ray_o.shape[0]
    dev = st.ray_o.device
    stream = st.stream

    li, alive = _shade_prologue(scene, static, st)
    its = prepare_from_rows(
        Rays(
            o=st.ray_o, d=st.ray_d,
            mint=torch.zeros(n, device=dev), maxt=torch.full((n,), INF, device=dev),
        ),
        st.rows,
    )[1]
    throughput = st.throughput
    eta = st.eta
    accum = st.accum_rough

    wi_local = its.sh_frame.to_local(-st.ray_d)
    lod, aniso = _texture_footprint(static, its, st.ray_d)
    ctx = bsdf_mod.make_ctx(static, scene, its.material, its.uv, its.sh_frame, wi_local,
                            its.dpdu, lod=lod, aniso=aniso)

    # (1) emitter hit ends the lane (integrator.cpp:226-231)
    hit_light = alive & (its.light >= 0)
    bw = torch.where(
        st.discrete,
        1.0,
        power_heuristic(st.bsdf_pdf, _light_pdf_at_hit(scene, its, st.ray_o)),
    )
    le = _light_eval_at_hit(scene, its, st.ray_o)
    li = li + torch.where(hit_light[:, None], bw[:, None] * throughput * le, 0.0)
    alive = alive & ~hit_light

    # (2) Russian roulette (integrator.cpp:237-244)
    if draw_rr:
        stream, u_rr = streams.next_1d(spec, stream)
        prob = torch.clamp(throughput.amax(dim=-1) * eta * eta, max=0.95)
        alive = alive & ~(prob <= u_rr)
        rr_scale = torch.where(alive, 1.0 / torch.clamp(prob, min=1e-9), 1.0)
        throughput = throughput * rr_scale[:, None]

    # (3) NEE over num_lights + 1 strata, the last one the environment
    do_env = _env_nee(static)
    n_strat = _nee_strata(static)
    if n_strat > 0:
        stream, u_pick = streams.next_1d(spec, stream)
        stream, u_tri = streams.next_1d(spec, stream)
        stream, u_a = streams.next_1d(spec, stream)
        stream, u_b = streams.next_1d(spec, stream)
        pick = kz_lights.select_uniform(n_strat, u_pick)
        if static.num_lights > 0:
            ls = kz_lights.sample_area_light(
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
        shadow = alive & (contrib != 0.0).any(dim=-1)
        smaxt = torch.where(shadow, nee_maxt, -1.0)
        n_shadow_rays = shadow.sum(dtype=torch.float32)
    else:
        nee_wi = st.ray_d
        contrib = torch.zeros((n, 3), device=dev)
        smaxt = torch.full((n,), -1.0, device=dev)
        n_shadow_rays = torch.zeros((), device=dev)

    # (4) roughness-bias firefly control (integrator.cpp:297-301)
    if static.regularization:
        reg = bsdf_mod.regularize_ctx(static, ctx)
        accum = torch.where(alive, accum + reg * static.accumulated_roughness, accum)

    # (5) BSDF sampling (integrator.cpp:303-309)
    stream, s1 = streams.next_1d(spec, stream)
    stream, s2 = streams.next_2d(spec, stream)
    res = bsdf_mod.sample_ctx(static, ctx, s1, s2, accum)
    throughput = torch.where(alive[:, None], throughput * res.weight, throughput)
    eta = torch.where(alive, eta * res.eta, eta)
    alive = alive & (res.weight > 0.0).any(dim=-1)
    pd = its.sh_frame.to_world(res.wo)
    n_path_rays = alive.sum(dtype=torch.float32)
    # the state as stored between stages: what the control rounds
    p, pd, nee_wi, contrib = kz.ROUND(its.p), kz.ROUND(pd), kz.ROUND(nee_wi), kz.ROUND(contrib)
    li, throughput = kz.ROUND(li), kz.ROUND(throughput)
    eta, accum = kz.ROUND(eta), kz.ROUND(accum)
    bsdf_pdf = kz.ROUND(res.pdf)

    # shadow trace, then path trace
    if n_strat > 0:
        occluded = _occluded(scene, p, nee_wi, static.trace_bias, smaxt, smaxt >= 0.0)
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
        discrete=res.is_discrete,
        accum_rough=accum,
        alive=alive,
        lane=st.lane,
        rays=st.rays + n_shadow_rays + n_path_rays,
    )


def wavefront_finish(scene, static, st: _OState):
    """Final miss -> background (this module's prologue) and the way back
    to pixel lane order. Returns (stream, li, nrays)."""
    li, _ = _shade_prologue(scene, static, st)
    inv = torch.argsort(st.lane)
    return st.stream.index(inv), li[inv], st.rays


def li_wavefront(scene, static, spec, stream, rays: Rays):
    """Integrator::Li over a lane batch: (stream, li (N, 3), rays traced)."""
    st = wavefront_init(scene, static, spec, stream, rays)
    for depth in range(static.max_depth):
        st = _bounce_ordered(scene, static, spec, st, draw_rr=depth >= 3)
    return wavefront_finish(scene, static, st)
