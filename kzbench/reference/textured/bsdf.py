"""The per-lane BSDF dispatch and shading context of the Textured
configuration: frozen copies of the port's ``shade/bsdf.py``
``eval_pdf_base`` and ``sample_base`` over the types Textured holds
(diffuse, GGX, kiss: ``kz/``'s lobes; roughconductor, roughplastic,
roughdielectric: ``lobes.py``), and ``make_ctx``, ``_wo_eff``,
``eval_pdf_ctx``, ``sample_ctx`` and ``regularize_ctx`` with the normalmap
wrapper resolved (bsdf.cpp:281-417), as ``con1/bsdf.py`` has them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kz.core import math as km
from ..kz.core.math import Frame
from ..kz.scene.compiler import (
    BSDF_DIFFUSE,
    BSDF_GGX,
    BSDF_KISS,
    BSDF_NORMALMAP,
    BSDF_ROUGHCONDUCTOR,
    BSDF_ROUGHDIELECTRIC,
    BSDF_ROUGHPLASTIC,
    MaterialTable,
)
from ..kz.shade import bsdf as kz
from ..kz.shade.bsdf import SampleResult, _cos, _mask3, _safe_dirs
from ..kz.shade.textures import eval_texture
from . import lobes

_BASE_BTYPES = (BSDF_DIFFUSE, BSDF_GGX, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC,
                BSDF_ROUGHDIELECTRIC, BSDF_KISS)


def _base_types(static):
    """The material types the dispatch runs (the normalmap wrapper is
    resolved before it)."""
    types = tuple(t for t in static.btypes_present if t != BSDF_NORMALMAP)
    bad = [t for t in types if t not in _BASE_BTYPES]
    if bad:
        raise ValueError(f"unhandled btype {bad}")
    return types


def eval_pdf_base(static, tex, mp, uv, wi, wo, accum_rough):
    """(eval, pdf) in one masked dispatch (the NEE hot path)."""
    out_f = torch.zeros_like(wi)
    out_p = torch.zeros(wi.shape[:-1], device=wi.device)
    wi0, wo0 = wi, wo
    for t in _base_types(static):
        m = mp.btype == t
        wi, wo = _safe_dirs(m, wi0, wo0)
        if t == BSDF_DIFFUSE:
            f, p = kz._diffuse_eval(mp.base_color, wi, wo), kz._diffuse_pdf(wi, wo)
        elif t == BSDF_GGX:
            f, p = kz._ggx_eval(static, tex, mp, uv, wi, wo), kz._ggx_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHCONDUCTOR:
            f, p = lobes.roughconductor_eval(mp, wi, wo), lobes.roughconductor_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHPLASTIC:
            f, p = lobes.roughplastic_eval(mp, wi, wo), lobes.roughplastic_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHDIELECTRIC:
            f, p = (lobes.roughdielectric_eval(mp, wi, wo),
                    lobes.roughdielectric_pdf(mp, wi, wo))
        else:
            f, p = kz._kiss_eval_pdf(static, tex, mp, uv, wi, wo, accum_rough)
        out_f = torch.where(m[..., None], f, out_f)
        out_p = torch.where(m, p, out_p)
    return out_f, out_p


def sample_base(static, tex, mp, uv, wi, s1, s2, accum_rough) -> SampleResult:
    n = wi.shape[:-1]
    out = SampleResult(
        wo=torch.zeros_like(wi),
        weight=torch.zeros_like(wi),
        eta=torch.ones(n, device=wi.device),
        is_discrete=torch.zeros(n, dtype=torch.bool, device=wi.device),
        pdf=torch.zeros(n, device=wi.device),
    )
    wi0 = wi
    for t in _base_types(static):
        m = mp.btype == t
        (wi,) = _safe_dirs(m, wi0)
        if t == BSDF_DIFFUSE:
            res = kz._diffuse_sample(mp.base_color, wi, s2)
        elif t == BSDF_GGX:
            res = kz._ggx_sample(static, tex, mp, uv, wi, s2)
        elif t == BSDF_ROUGHCONDUCTOR:
            res = lobes.roughconductor_sample(mp, wi, s2)
        elif t == BSDF_ROUGHPLASTIC:
            res = lobes.roughplastic_sample(mp, wi, s1, s2)
        elif t == BSDF_ROUGHDIELECTRIC:
            res = lobes.roughdielectric_sample(mp, wi, s1, s2)
        else:
            res = kz._kiss_sample(static, tex, mp, uv, wi, s1, s2, accum_rough)
        out = SampleResult(
            *(
                torch.where(m[..., None] if new.dim() == 2 else m, new, old)
                for new, old in zip(res, out)
            )
        )
    return out


class ShadeCtx(NamedTuple):
    """Per-hit shading context: material rows fetched once, the normalmap
    frame resolved once; eval, pdf and sample share it."""

    textures: object  # the scene's TexturePool
    mp: MaterialTable  # per-lane material rows
    mp_eff: MaterialTable  # the same with each normalmap's nested material
    uv: torch.Tensor  # (N, 2), or (N, 3)/(N, 5) with the mip footprint
    sh_frame: Frame
    wi: torch.Tensor  # (N, 3) local wi (unperturbed)
    wi_eff: torch.Tensor  # wi in the frame the nested material sees
    perturbed: torch.Tensor  # (N,) bool: the normal map moved the frame
    pframe: Frame  # the perturbed frame (sh_frame where unused)


def make_ctx(static, scene, mat_id, uv, sh_frame, wi, dpdu, lod=None, aniso=None) -> ShadeCtx:
    """The shading context of hits on materials ``mat_id``; ``dpdu`` is the
    hits' surface tangent, ``lod`` and ``aniso`` the mip footprint (extra uv
    columns [u, v, lod, maj_du, maj_dv])."""
    if lod is not None and getattr(static, "mip_textures", False):
        cols = [uv, lod[..., None]]
        if aniso is not None:
            cols += [aniso[0][..., None], aniso[1][..., None]]
        uv = torch.cat(cols, dim=-1)
    tex = scene.textures
    mp = scene.materials.rows(mat_id)
    _base_types(static)
    if BSDF_NORMALMAP not in static.btypes_present:
        no = torch.zeros(wi.shape[:-1], dtype=torch.bool, device=wi.device)
        return ShadeCtx(tex, mp, mp, uv, sh_frame, wi, wi, no, sh_frame)
    is_nm = mp.btype == BSDF_NORMALMAP
    mp_eff = scene.materials.rows(torch.where(is_nm, mp.nested, mat_id))
    flat = torch.tensor([0.5, 0.5, 1.0], dtype=wi.dtype, device=wi.device)
    rgb = eval_texture(static, tex, mp.tex_normal, uv, flat.expand_as(wi))
    n_t = 2.0 * rgb - 1.0
    # hemisphere-consistency shortcut (bsdf.cpp:295-297): where the mapped
    # normal faces away from wi, the nested BSDF runs unperturbed
    shortcut = (_cos(wi) > 0.0) & (km.dot(n_t, wi) <= 0.0)
    # getFrame (bsdf.cpp:366-378)
    n_w = km.normalize(sh_frame.to_world(km.normalize(n_t)))
    s_p = km.normalize(dpdu - n_w * km.dot(n_w, dpdu, keepdims=True))
    t_p = km.normalize(km.cross(n_w, s_p))
    pframe = Frame(s=s_p, t=t_p, n=n_w)
    perturbed = is_nm & ~shortcut
    wi_eff = torch.where(perturbed[..., None], pframe.to_local(sh_frame.to_world(wi)), wi)
    return ShadeCtx(tex, mp, mp_eff, uv, sh_frame, wi, wi_eff, perturbed, pframe)


def _wo_eff(static, ctx: ShadeCtx, wo):
    """(wo as the nested material sees it, lanes where the perturbation
    flips wo's hemisphere)."""
    if BSDF_NORMALMAP not in static.btypes_present:
        return wo, None
    wo_p = ctx.pframe.to_local(ctx.sh_frame.to_world(wo))
    wo_eff = torch.where(ctx.perturbed[..., None], wo_p, wo)
    return wo_eff, ctx.perturbed & (_cos(wo) * _cos(wo_p) <= 0.0)


def eval_pdf_ctx(static, ctx: ShadeCtx, wo, accum_rough):
    wo_eff, bad = _wo_eff(static, ctx, wo)
    f, p = eval_pdf_base(
        static, ctx.textures, ctx.mp_eff, ctx.uv, ctx.wi_eff, wo_eff, accum_rough
    )
    if bad is None:
        return f, p
    return _mask3(~bad, f), torch.where(bad, 0.0, p)


def sample_ctx(static, ctx: ShadeCtx, s1, s2, accum_rough) -> SampleResult:
    res = sample_base(
        static, ctx.textures, ctx.mp_eff, ctx.uv, ctx.wi_eff, s1, s2, accum_rough
    )
    if BSDF_NORMALMAP not in static.btypes_present:
        return res
    # map the sampled direction back through the perturbed frame
    # (bsdf.cpp:357-362) and reject hemisphere flips
    wo_back = ctx.sh_frame.to_local(ctx.pframe.to_world(res.wo))
    wo = torch.where(ctx.perturbed[..., None], wo_back, res.wo)
    bad = ctx.perturbed & (_cos(wo) * _cos(res.wo) <= 0.0)
    return res._replace(
        wo=wo, weight=_mask3(~bad, res.weight), pdf=torch.where(bad, 0.0, res.pdf)
    )


def regularize_ctx(static, ctx: ShadeCtx):
    """BSDF::regularize with normalmap forwarding (bsdf.cpp:412): kiss
    returns its roughness texture (bsdf.cpp:1397-1399), every other model 0
    (bsdf.h:125)."""
    if BSDF_KISS not in static.btypes_present:
        return torch.zeros(ctx.uv.shape[:-1], device=ctx.uv.device)
    mp = ctx.mp_eff
    rough = kz._scalar_texture(static, ctx.textures, mp.tex_roughness, ctx.uv, mp.roughness)
    return torch.where(mp.btype == BSDF_KISS, rough, 0.0)
