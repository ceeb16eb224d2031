"""Debug integrators: normals, ao, whitted and path_mats
(integrator.cpp:11-181), as masked wavefronts over the path_mis stages.

The port of ``kazen_tpu/integrate/simple.py``: the reference's debugging
ladder, each rung running a subset of the pipeline. Every trace, the shadow
tests of ao and whitted included, is a nearest-hit query through the trace
kernel K1 (``path_mis.intersect``), as in the reference. A lane that has
ended, or whose shadow answer no output reads, traces an empty ray (maxt
< 0) that leaves the kernel at the root; every output is unchanged by it.
"""
from __future__ import annotations

import math

import torch

from ..accel.intersect import Rays
from ..core import math as km
from ..core import warp
from ..samplers import streams
from ..scene.compiler import BSDF_DIFFUSE, BSDF_LAMBERTIAN
from ..shade import bsdf as bsdf_mod
from ..shade import lights as lights_mod
from ..shade.interaction import prepare
from .path_mis import EPSILON, INF, intersect

_WHITTED_MAX_DEPTH = 16


def _hit(scene, o, d, mint, maxt, live):
    """(rays, nearest hit) of rays whose lanes ``live`` need an answer."""
    rays = Rays(o=o, d=d, mint=mint, maxt=torch.where(live, maxt, -1.0))
    return rays, intersect(scene, rays)


def li_normals(scene, static, spec, stream, rays: Rays):
    """NormalIntegrator (integrator.cpp:11-34): |geometric normal|."""
    its = prepare(scene, rays, intersect(scene, rays))
    col = torch.where(its.valid[:, None], torch.abs(its.geo_frame.n), 0.0)
    return stream, col, torch.full((), float(rays.o.shape[0]), device=rays.o.device)


def li_ao(scene, static, spec, stream, rays: Rays):
    """AmbientOcclusionIntegrator (integrator.cpp:37-70)."""
    n = rays.o.shape[0]
    dev = rays.o.device
    its = prepare(scene, rays, intersect(scene, rays))
    stream, u2 = streams.next_2d(spec, stream)
    point = its.sh_frame.to_world(warp.square_to_uniform_hemisphere(u2))
    _, sh = _hit(
        scene, its.p, point, torch.full((n,), EPSILON, device=dev),
        torch.full((n,), INF, device=dev), its.valid,
    )
    cos_theta = its.sh_frame.to_local(km.normalize(point))[..., 2]
    val = (cos_theta / math.pi) / km.INV_TWOPI
    visible = its.valid & ~sh.valid
    col = torch.where(visible[:, None], val[:, None].expand(n, 3), 0.0)
    return stream, col, float(n) + its.valid.sum(dtype=torch.float32)


def li_path_mats(scene, static, spec, stream, rays: Rays):
    """PathMatsIntegrator (integrator.cpp:137-181): BSDF sampling only,
    Russian roulette on throughput.x with a ``>=`` kill, at most
    static.max_depth bounces."""
    n = rays.o.shape[0]
    dev = rays.o.device
    color = torch.zeros((n, 3), device=dev)
    t = torch.ones((n, 3), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    ray_o, ray_d, mint, maxt = rays
    nrays = torch.full((), float(n), device=dev)
    accum = torch.zeros(n, device=dev)
    for _ in range(static.max_depth):
        its = prepare(scene, *_hit(scene, ray_o, ray_d, mint, maxt, alive))
        alive = alive & its.valid
        # emitter contribution
        hit_light = alive & (its.light >= 0)
        wi = km.normalize(its.p - ray_o)
        le = lights_mod.eval_area_light(
            scene, torch.clamp(its.light, min=0), its.sh_frame.n, wi
        )
        color = color + torch.where(hit_light[:, None], t * le, 0.0)
        # Russian roulette
        stream, u = streams.next_1d(spec, stream)
        prob = torch.clamp(t[:, 0], max=0.95)
        alive = alive & (u < prob)
        t = torch.where(alive[:, None], t / torch.clamp(prob, min=1e-9)[:, None], t)
        # BSDF
        wi_local = its.sh_frame.to_local(-ray_d)
        stream, s1 = streams.next_1d(spec, stream)
        stream, s2 = streams.next_2d(spec, stream)
        res = bsdf_mod.sample(
            static, scene, its.material, its.uv, its.sh_frame, its.dpdu, wi_local, s1, s2,
            accum,
        )
        t = torch.where(alive[:, None], t * res.weight, t)
        alive = alive & (res.weight > 0.0).any(dim=-1)
        ray_o = torch.where(alive[:, None], its.p, ray_o)
        ray_d = torch.where(alive[:, None], its.sh_frame.to_world(res.wo), ray_d)
        mint = torch.full((n,), EPSILON, device=dev)
        maxt = torch.full((n,), INF, device=dev)
        nrays = nrays + alive.sum(dtype=torch.float32)
    return stream, color, nrays


def li_whitted(scene, static, spec, stream, rays: Rays):
    """WhittedIntegrator (integrator.cpp:74-134): one light sample on
    diffuse surfaces, continuation through specular ones with Russian
    roulette at 0.95, at most min(16, static.max_depth) bounces."""
    n = rays.o.shape[0]
    dev = rays.o.device
    color = torch.zeros((n, 3), device=dev)
    weight = torch.ones((n, 3), device=dev)  # specular sample weights / 0.95
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    ray_o, ray_d, mint, maxt = rays
    nrays = torch.full((), float(n), device=dev)
    accum = torch.zeros(n, device=dev)
    btypes = scene.materials.btype
    for _ in range(min(_WHITTED_MAX_DEPTH, static.max_depth)):
        its = prepare(scene, *_hit(scene, ray_o, ray_d, mint, maxt, alive))
        alive = alive & its.valid
        btype = btypes[its.material]
        is_diffuse = (btype == BSDF_DIFFUSE) | (btype == BSDF_LAMBERTIAN)

        # Le of directly visible lights
        hit_light = alive & (its.light >= 0)
        wi_cam = km.normalize(its.p - ray_o)
        le = lights_mod.eval_area_light(
            scene, torch.clamp(its.light, min=0), its.sh_frame.n, wi_cam
        )
        le = torch.where(hit_light[:, None], le, 0.0)

        # diffuse branch: one light sample
        stream, u_pick = streams.next_1d(spec, stream)
        stream, u_tri = streams.next_1d(spec, stream)
        stream, u_a = streams.next_1d(spec, stream)
        stream, u_b = streams.next_1d(spec, stream)
        if static.num_lights > 0:
            lidx = lights_mod.select_uniform(static.num_lights, u_pick)
            ls = lights_mod.sample_area_light(scene, lidx, its.p, u_tri, u_a, u_b)
            _, occ = _hit(
                scene, its.p, ls.wi, torch.full((n,), EPSILON, device=dev), ls.dist,
                alive & is_diffuse,
            )
            occ = occ.valid
            ls_val = torch.where(occ[:, None], 0.0, ls.ls)
            cos_theta = torch.clamp(its.sh_frame.to_local(ls.wi)[..., 2], min=0.0)
            wi_local = its.sh_frame.to_local(-ray_d)
            wo_local = its.sh_frame.to_local(ls.wi)
            f = bsdf_mod.eval(
                static, scene, its.material, its.uv, its.sh_frame, its.dpdu, wi_local,
                wo_local, accum,
            )
            # the reference multiplies eval (which folds in the cosine) by
            # the cosine again (integrator.cpp:104-113); kept as it is
            lr = f * ls_val * cos_theta[:, None] * static.num_lights
        else:
            lr = torch.zeros((n, 3), device=dev)
        color = color + torch.where((alive & is_diffuse)[:, None], weight * (le + lr), 0.0)

        # specular branch: sample the BSDF, Russian roulette at 0.95, go on
        wi_local = its.sh_frame.to_local(-ray_d)
        stream, s1 = streams.next_1d(spec, stream)
        stream, s2 = streams.next_2d(spec, stream)
        res = bsdf_mod.sample(
            static, scene, its.material, its.uv, its.sh_frame, its.dpdu, wi_local, s1, s2,
            accum,
        )
        stream, u_rr = streams.next_1d(spec, stream)
        cont = alive & ~is_diffuse & (u_rr < 0.95)
        weight = torch.where(cont[:, None], weight * res.weight / 0.95, weight)
        alive = cont & (res.weight > 0.0).any(dim=-1)
        ray_o = torch.where(alive[:, None], its.p, ray_o)
        ray_d = torch.where(alive[:, None], its.sh_frame.to_world(res.wo), ray_d)
        mint = torch.full((n,), EPSILON, device=dev)
        maxt = torch.full((n,), INF, device=dev)
        nrays = nrays + alive.sum(dtype=torch.float32)
    return stream, color, nrays


LI_FNS = {
    "normals": li_normals,
    "ao": li_ao,
    "whitted": li_whitted,
    "path_mats": li_path_mats,
}
