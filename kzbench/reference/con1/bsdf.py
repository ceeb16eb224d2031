"""The shading context with the normalmap wrapper resolved (bsdf.cpp:
281-417): frozen copies of the port's ``shade/bsdf.py`` ``make_ctx``,
``_wo_eff``, ``eval_pdf_ctx``, ``sample_ctx`` and ``regularize_ctx``,
around the lobes of ``kz/shade/bsdf.py``.

The normal map perturbs the shading frame from its tangent-space normal
texture; the nested material sees directions re-expressed in that frame,
and a direction whose hemisphere the perturbation flips gets nothing. The
lobes run with a ``static`` whose ``btypes_present`` leaves the normalmap
out, since each lane's material is its nested one by then.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..kz.core import math as km
from ..kz.core.math import Frame
from ..kz.shade import bsdf as base
from ..kz.shade.textures import eval_texture
from .compiler import BSDF_NORMALMAP


class ShadeCtx(NamedTuple):
    """Per-hit shading context: the lobes' own context (``kz/``'s, on each
    lane's nested material and the direction it sees) and the normal map's
    frame."""

    static: object  # the scene's static, without the normalmap's btype
    base: base.ShadeCtx
    sh_frame: Frame
    perturbed: Optional[torch.Tensor]  # (N,) bool: the normal map moved the frame
    pframe: Optional[Frame]  # the perturbed frame


def make_ctx(static, scene, mat_id, uv, sh_frame, wi, dpdu, lod=None,
             aniso=None) -> ShadeCtx:
    """The shading context of hits on materials ``mat_id``; ``dpdu`` is the
    hits' surface tangent, ``lod`` and ``aniso`` the mip footprint."""
    lobes = dataclasses.replace(static, btypes_present=tuple(
        t for t in static.btypes_present if t != BSDF_NORMALMAP))
    if BSDF_NORMALMAP not in static.btypes_present:
        return ShadeCtx(lobes, base.make_ctx(lobes, scene, mat_id, uv, wi, lod, aniso),
                        sh_frame, None, None)
    mp = scene.materials.rows(mat_id)
    is_nm = mp.btype == BSDF_NORMALMAP
    ctx = base.make_ctx(lobes, scene, torch.where(is_nm, mp.nested, mat_id), uv, wi, lod,
                        aniso)
    flat = torch.tensor([0.5, 0.5, 1.0], dtype=wi.dtype, device=wi.device)
    rgb = eval_texture(static, scene.textures, mp.tex_normal, ctx.uv, flat.expand_as(wi))
    n_t = 2.0 * rgb - 1.0
    # hemisphere-consistency shortcut (bsdf.cpp:295-297): where the mapped
    # normal faces away from wi, the nested BSDF runs unperturbed
    shortcut = (base._cos(wi) > 0.0) & (km.dot(n_t, wi) <= 0.0)
    # getFrame (bsdf.cpp:366-378)
    n_w = km.normalize(sh_frame.to_world(km.normalize(n_t)))
    s_p = km.normalize(dpdu - n_w * km.dot(n_w, dpdu, keepdims=True))
    t_p = km.normalize(km.cross(n_w, s_p))
    pframe = Frame(s=s_p, t=t_p, n=n_w)
    perturbed = is_nm & ~shortcut
    wi_eff = torch.where(perturbed[..., None], pframe.to_local(sh_frame.to_world(wi)), wi)
    return ShadeCtx(lobes, ctx._replace(wi=wi_eff), sh_frame, perturbed, pframe)


def _wo_eff(ctx: ShadeCtx, wo):
    """(wo as the nested material sees it, lanes where the perturbation
    flips wo's hemisphere)."""
    if ctx.perturbed is None:
        return wo, None
    wo_p = ctx.pframe.to_local(ctx.sh_frame.to_world(wo))
    wo_eff = torch.where(ctx.perturbed[..., None], wo_p, wo)
    return wo_eff, ctx.perturbed & (base._cos(wo) * base._cos(wo_p) <= 0.0)


def eval_pdf_ctx(static, ctx: ShadeCtx, wo, accum_rough):
    wo_eff, bad = _wo_eff(ctx, wo)
    f, p = base.eval_pdf_ctx(ctx.static, ctx.base, wo_eff, accum_rough)
    if bad is None:
        return f, p
    return base._mask3(~bad, f), torch.where(bad, 0.0, p)


def sample_ctx(static, ctx: ShadeCtx, s1, s2, accum_rough) -> base.SampleResult:
    res = base.sample_ctx(ctx.static, ctx.base, s1, s2, accum_rough)
    if ctx.perturbed is None:
        return res
    # map the sampled direction back through the perturbed frame
    # (bsdf.cpp:357-362) and reject hemisphere flips
    wo_back = ctx.sh_frame.to_local(ctx.pframe.to_world(res.wo))
    wo = torch.where(ctx.perturbed[..., None], wo_back, res.wo)
    bad = ctx.perturbed & (base._cos(wo) * base._cos(res.wo) <= 0.0)
    return res._replace(
        wo=wo, weight=base._mask3(~bad, res.weight), pdf=torch.where(bad, 0.0, res.pdf)
    )


def regularize_ctx(static, ctx: ShadeCtx):
    """BSDF::regularize with normalmap forwarding (bsdf.cpp:412): the
    nested material's."""
    return base.regularize_ctx(ctx.static, ctx.base)
