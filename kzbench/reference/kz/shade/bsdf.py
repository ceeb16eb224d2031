"""BSDFs as functions over per-lane shade batches (bsdf.cpp).

A frozen copy of the port's BSDFs, cut to those the benchmark's
configurations use: diffuse, GGX and kiss (KazenStandardSurface,
bsdf.cpp:1157-1418), with textured parameters. Conventions follow
bsdf.h:58-127: directions are in the local shading frame; ``eval`` returns
f*cos(theta_o); ``pdf`` is w.r.t. solid angle and 0 for discrete lobes;
``sample`` returns the weight f*cos/pdf.

Per-lane dispatch runs every material type present in the scene
(``static.btypes_present``) on the whole batch under a mask, as the
reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as km
from ..core import warp
from ..scene.compiler import BSDF_DIFFUSE, BSDF_GGX, BSDF_KISS, MaterialTable
from . import ggx
from .textures import eval_texture

EPS = 1e-4  # reference Epsilon (define.h)


class SampleResult(NamedTuple):
    wo: torch.Tensor  # (N, 3) local
    weight: torch.Tensor  # (N, 3) f*cos/pdf
    eta: torch.Tensor  # (N,)
    is_discrete: torch.Tensor  # (N,) bool
    pdf: torch.Tensor  # (N,) solid-angle pdf of wo (what pdf() would return)


def _cos(v):
    return v[..., 2]


def _mask3(m, x):
    return torch.where(m[..., None], x, 0.0)


_BASE_BTYPES = (BSDF_DIFFUSE, BSDF_GGX, BSDF_KISS)


def _base_types(static):
    """The material types the dispatch runs."""
    types = tuple(static.btypes_present)
    bad = [t for t in types if t not in _BASE_BTYPES]
    if bad:
        raise ValueError(f"unhandled btype {bad}")
    return types


def _safe_dirs(m, *vs):
    """Every per-type branch runs on all lanes and is masked afterwards;
    lanes of other types compute with +z directions (the reference's
    masked-dispatch hygiene)."""
    z = torch.zeros_like(vs[0])
    z[..., 2] = 1.0
    return tuple(torch.where(m[..., None], v, z) for v in vs)


# ---------------------------------------------------------------------------
# diffuse (bsdf.cpp:63-106)
# ---------------------------------------------------------------------------


def _diffuse_eval(albedo, wi, wo):
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return _mask3(m, albedo * (km.INV_PI * _cos(wo))[..., None])


def _diffuse_pdf(wi, wo):
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return torch.where(m, km.INV_PI * _cos(wo), 0.0)


def _diffuse_sample(albedo, wi, s2):
    wo = warp.square_to_cosine_hemisphere(s2)
    w = _mask3(_cos(wi) > 0.0, albedo)
    n = wi.shape[:-1]
    return (
        wo, w, torch.ones(n, device=wi.device),
        torch.zeros(n, dtype=torch.bool, device=wi.device), _diffuse_pdf(wi, wo),
    )


# ---------------------------------------------------------------------------
# ggx (bsdf.cpp:629-689): GGX-Smith VNDF BRDF
# ---------------------------------------------------------------------------


def _ggx_eval(static, tex, mp, uv, wi, wo):
    albedo = eval_texture(static, tex, mp.tex_base, uv, mp.base_color)
    f, _ = ggx.eval_ggx_smith_brdf(wi, wo, albedo, mp.roughness, mp.anisotropy)
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return _mask3(m, f * _cos(wo)[..., None])


def _ggx_pdf(mp, wi, wo):
    h = km.normalize(wi + wo)
    alpha = ggx.roughness_to_alpha(mp.roughness, mp.anisotropy)
    denom = 4.0 * km.dot(wi, h)
    pdf = ggx.vndf(wi, h, alpha) / torch.where(denom == 0.0, 1e-9, denom)
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return torch.where(m, pdf, 0.0)


def _ggx_sample(static, tex, mp, uv, wi, s2):
    alpha = ggx.roughness_to_alpha(mp.roughness, mp.anisotropy)
    wo = km.reflect(wi, ggx.sample_vndf(wi, alpha, s2))
    val = _ggx_eval(static, tex, mp, uv, wi, wo)
    pdf = _ggx_pdf(mp, wi, wo)
    w = val / torch.clamp(pdf, min=1e-9)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (pdf > 0.0)
    n = wi.shape[:-1]
    return (
        wo, _mask3(m, w), torch.ones(n, device=wi.device),
        torch.zeros(n, dtype=torch.bool, device=wi.device), pdf,
    )


# ---------------------------------------------------------------------------
# kiss / KazenStandardSurface (bsdf.cpp:1157-1418)
# ---------------------------------------------------------------------------


def _scalar_texture(static, tex, tex_id, uv, const):
    """A scalar parameter's texture: its first channel, the constant on
    untextured lanes (every lane where the scene has no image or composite
    texture, as eval_texture says)."""
    if not static.has_composite_textures and not static.has_image_textures:
        return const
    return eval_texture(static, tex, tex_id, uv, torch.stack([const] * 3, -1))[..., 0]


def _kiss_textures(static, tex, mp, uv):
    base = eval_texture(static, tex, mp.tex_base, uv, mp.base_color)
    metallic = _scalar_texture(static, tex, mp.tex_metallic, uv, mp.metallic)
    roughness = _scalar_texture(static, tex, mp.tex_roughness, uv, mp.roughness)
    return base, metallic, roughness


def _schlick_weight(x):
    x = torch.clamp(1.0 - x, 0.0, 1.0)
    return km.sqr(km.sqr(x)) * x


def _kiss_eval(static, tex, mp, uv, wi, wo, accum_rough):
    v, l = wi, wo
    h = km.normalize(v + l)
    cdlin, metallic, rough_tex = _kiss_textures(static, tex, mp, uv)
    roughness = torch.clamp(rough_tex + accum_rough, max=1.0)
    cdlum = km.luminance(cdlin)
    ctint = torch.where(
        (cdlum > 0.0)[..., None], cdlin / torch.clamp(cdlum, min=1e-9)[..., None], 1.0
    )
    ctintmix = (0.08 * mp.specular)[..., None] * km.lerp(
        mp.specular_tint[..., None], torch.ones_like(ctint), ctint
    )
    cspec0 = km.lerp(metallic[..., None], ctintmix, cdlin)

    fl = _schlick_weight(_cos(l))
    fv = _schlick_weight(_cos(v))
    fh = _schlick_weight(km.dot(l, h))
    cos_d = km.dot(v, h)

    lambert = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    rr = 2.0 * roughness * cos_d * cos_d
    retro = rr * (fl + fv + fl * fv * (rr - 1.0))

    csheen = km.lerp(mp.sheen_tint[..., None], torch.ones_like(ctint), ctint)
    fsheen = fh[..., None] * mp.sheen[..., None] * csheen

    spec, _ = ggx.eval_ggx_smith_brdf(v, l, cspec0, roughness, mp.anisotropy)
    cc_rough = km.lerp(mp.clearcoat_roughness, 0.01, 0.3)
    cc, _ = ggx.eval_ggx_smith_brdf(
        v, l, torch.full_like(cspec0, 0.04), cc_rough, mp.anisotropy
    )
    clearcoat = 0.25 * mp.clearcoat[..., None] * cc

    val = (
        (1.0 - metallic)[..., None]
        * (cdlin * (km.INV_PI * (lambert + retro))[..., None] + fsheen)
        + spec
        + clearcoat
    ) * _cos(wo)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return _mask3(m, val)


def _kiss_pdf(static, tex, mp, uv, wi, wo, accum_rough):
    _, metallic, rough_tex = _kiss_textures(static, tex, mp, uv)
    diffuse = (1.0 - metallic) * 0.5
    gtr2 = 1.0 / (1.0 + mp.clearcoat)
    h = km.normalize(wi + wo)
    jacobian = 4.0 * km.dot(wi, h)
    jacobian = torch.where(jacobian == 0.0, 1e-9, jacobian)
    roughness = torch.clamp(rough_tex + accum_rough, max=1.0)
    alpha = ggx.roughness_to_alpha(roughness, mp.anisotropy)
    spec_pdf = ggx.vndf(wi, h, alpha) / jacobian
    coat_alpha = ggx.roughness_to_alpha(
        km.lerp(mp.clearcoat_roughness, 0.01, 0.3), torch.zeros_like(mp.anisotropy)
    )
    coat_pdf = ggx.vndf(wi, h, coat_alpha) / jacobian
    pdf = diffuse * km.INV_PI * _cos(wo) + (1.0 - diffuse) * (
        gtr2 * spec_pdf + (1.0 - gtr2) * coat_pdf
    )
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return torch.where(m, pdf, 0.0)


def _kiss_eval_pdf(static, tex, mp, uv, wi, wo, accum_rough):
    """eval + pdf in one pass sharing the textures, H and the alphas."""
    v, l = wi, wo
    h = km.normalize(v + l)
    cdlin, metallic, rough_tex = _kiss_textures(static, tex, mp, uv)
    roughness = torch.clamp(rough_tex + accum_rough, max=1.0)
    alpha = ggx.roughness_to_alpha(roughness, mp.anisotropy)
    cc_rough = km.lerp(mp.clearcoat_roughness, 0.01, 0.3)
    coat_alpha_e = ggx.roughness_to_alpha(cc_rough, mp.anisotropy)
    coat_alpha_p = ggx.roughness_to_alpha(cc_rough, torch.zeros_like(mp.anisotropy))

    # eval
    cdlum = km.luminance(cdlin)
    ctint = torch.where(
        (cdlum > 0.0)[..., None], cdlin / torch.clamp(cdlum, min=1e-9)[..., None], 1.0
    )
    ctintmix = (0.08 * mp.specular)[..., None] * km.lerp(
        mp.specular_tint[..., None], torch.ones_like(ctint), ctint
    )
    cspec0 = km.lerp(metallic[..., None], ctintmix, cdlin)
    fl = _schlick_weight(_cos(l))
    fv = _schlick_weight(_cos(v))
    fh = _schlick_weight(km.dot(l, h))
    cos_d = km.dot(v, h)
    lambert = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    rr = 2.0 * roughness * cos_d * cos_d
    retro = rr * (fl + fv + fl * fv * (rr - 1.0))
    csheen = km.lerp(mp.sheen_tint[..., None], torch.ones_like(ctint), ctint)
    fsheen = fh[..., None] * mp.sheen[..., None] * csheen

    d_spec = ggx.ggx_ndf(h, alpha)
    g_spec = ggx.smith_g2(v, l, h, alpha)
    f_spec = ggx.schlick_fresnel(cspec0, cos_d)
    denom = torch.clamp(4.0 * torch.abs(_cos(v)) * torch.abs(_cos(l)), min=1e-9)
    opp = (_cos(v) * _cos(l) < 0.0)[..., None]
    spec = torch.where(opp, 0.0, (d_spec * g_spec / denom)[..., None] * f_spec)
    d_cc = ggx.ggx_ndf(h, coat_alpha_e)
    g_cc = ggx.smith_g2(v, l, h, coat_alpha_e)
    f_cc = ggx.schlick_fresnel(torch.full_like(cspec0, 0.04), cos_d)
    cc = torch.where(opp, 0.0, (d_cc * g_cc / denom)[..., None] * f_cc)
    clearcoat = 0.25 * mp.clearcoat[..., None] * cc
    val = (
        (1.0 - metallic)[..., None]
        * (cdlin * (km.INV_PI * (lambert + retro))[..., None] + fsheen)
        + spec
        + clearcoat
    ) * _cos(wo)[..., None]

    # pdf (the clearcoat pdf uses the isotropic alpha, as the reference's
    # roughnessToAlpha(..., 0))
    diffuse_p = (1.0 - metallic) * 0.5
    gtr2 = 1.0 / (1.0 + mp.clearcoat)
    jacobian = 4.0 * km.dot(wi, h)
    jacobian = torch.where(jacobian == 0.0, 1e-9, jacobian)
    spec_pdf = ggx.vndf(wi, h, alpha) / jacobian
    coat_pdf = ggx.vndf(wi, h, coat_alpha_p) / jacobian
    pdf = diffuse_p * km.INV_PI * _cos(wo) + (1.0 - diffuse_p) * (
        gtr2 * spec_pdf + (1.0 - gtr2) * coat_pdf
    )

    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    return _mask3(m, val), torch.where(m, pdf, 0.0)


def _kiss_sample(static, tex, mp, uv, wi, s1, s2, accum_rough):
    _, metallic, rough_tex = _kiss_textures(static, tex, mp, uv)
    diffuse = (1.0 - metallic) * 0.5
    gtr2 = 1.0 / (1.0 + mp.clearcoat)

    wo_diff = warp.square_to_cosine_hemisphere(s2)

    # specular/clearcoat H: lobe select by the rescaled sample1
    # (bsdf.cpp:1317-1336); the sampled H uses the unregularized roughness,
    # as the reference does
    s_rescaled = (s1 - diffuse) / torch.clamp(1.0 - diffuse, min=1e-9)
    flip = _cos(wi) <= 0.0
    wi_f = torch.where(flip[..., None], -wi, wi)
    alpha_spec = ggx.roughness_to_alpha(rough_tex, mp.anisotropy)
    alpha_coat = ggx.roughness_to_alpha(
        km.lerp(mp.clearcoat_roughness, 0.01, 0.3), torch.zeros_like(mp.anisotropy)
    )
    use_spec = s_rescaled < gtr2
    alpha = torch.where(use_spec[..., None], alpha_spec, alpha_coat)
    h = ggx.sample_vndf(wi_f, alpha, s2)
    h = torch.where(flip[..., None], -h, h)
    wo_spec = km.normalize(km.reflect(wi, h))

    wo = torch.where((s1 < diffuse)[..., None], wo_diff, wo_spec)
    val = _kiss_eval(static, tex, mp, uv, wi, wo, accum_rough)
    pdf = _kiss_pdf(static, tex, mp, uv, wi, wo, accum_rough)
    w = val / torch.clamp(pdf, min=1e-9)[..., None]
    ok = (
        (_cos(wi) > 0.0)
        & (_cos(wo) > 0.0)
        & (pdf > EPS)
        & torch.isfinite(wo).all(dim=-1)
    )
    w = torch.where(torch.isfinite(w), w, 0.0)
    return (
        wo, _mask3(ok, w), torch.ones_like(s1),
        torch.zeros(s1.shape, dtype=torch.bool, device=s1.device), pdf,
    )


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def eval_pdf_base(static, tex, mp, uv, wi, wo, accum_rough):
    """(eval, pdf) in one masked dispatch (the NEE hot path)."""
    out_f = torch.zeros_like(wi)
    out_p = torch.zeros(wi.shape[:-1], device=wi.device)
    wi0, wo0 = wi, wo
    for t in _base_types(static):
        m = mp.btype == t
        wi, wo = _safe_dirs(m, wi0, wo0)
        if t == BSDF_DIFFUSE:
            f = _diffuse_eval(mp.base_color, wi, wo)
            p = _diffuse_pdf(wi, wo)
        elif t == BSDF_GGX:
            f = _ggx_eval(static, tex, mp, uv, wi, wo)
            p = _ggx_pdf(mp, wi, wo)
        else:
            f, p = _kiss_eval_pdf(static, tex, mp, uv, wi, wo, accum_rough)
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
            res = _diffuse_sample(mp.base_color, wi, s2)
        elif t == BSDF_GGX:
            res = _ggx_sample(static, tex, mp, uv, wi, s2)
        else:
            res = _kiss_sample(static, tex, mp, uv, wi, s1, s2, accum_rough)
        out = SampleResult(
            *(
                torch.where(m[..., None] if new.dim() == 2 else m, new, old)
                for new, old in zip(res, out)
            )
        )
    return out


# ---------------------------------------------------------------------------
# the shading context
# ---------------------------------------------------------------------------


class ShadeCtx(NamedTuple):
    """Per-hit shading context: material rows fetched once; eval, pdf and
    sample share it."""

    textures: object  # the scene's TexturePool
    mp: MaterialTable  # per-lane material rows
    uv: torch.Tensor  # (N, 2), or (N, 3)/(N, 5) with the mip footprint
    wi: torch.Tensor  # (N, 3) local wi


def make_ctx(static, scene, mat_id, uv, wi, lod=None, aniso=None) -> ShadeCtx:
    """The shading context of hits on materials ``mat_id``. ``lod`` and
    ``aniso`` (path_mis._texture_footprint) thread the mip footprint to
    every texture fetch as extra uv columns [u, v, lod, maj_du, maj_dv]."""
    if lod is not None and getattr(static, "mip_textures", False):
        cols = [uv, lod[..., None]]
        if aniso is not None:
            cols += [aniso[0][..., None], aniso[1][..., None]]
        uv = torch.cat(cols, dim=-1)
    _base_types(static)
    return ShadeCtx(scene.textures, scene.materials.rows(mat_id), uv, wi)


def eval_pdf_ctx(static, ctx: ShadeCtx, wo, accum_rough):
    return eval_pdf_base(static, ctx.textures, ctx.mp, ctx.uv, ctx.wi, wo, accum_rough)


def sample_ctx(static, ctx: ShadeCtx, s1, s2, accum_rough) -> SampleResult:
    return sample_base(static, ctx.textures, ctx.mp, ctx.uv, ctx.wi, s1, s2, accum_rough)


def regularize_ctx(static, ctx: ShadeCtx):
    """BSDF::regularize (bsdf.cpp:412): kiss returns its roughness texture
    (bsdf.cpp:1397-1399), every other model 0 (bsdf.h:125)."""
    if BSDF_KISS not in static.btypes_present:
        return torch.zeros(ctx.uv.shape[:-1], device=ctx.uv.device)
    mp = ctx.mp
    rough = _scalar_texture(static, ctx.textures, mp.tex_roughness, ctx.uv, mp.roughness)
    return torch.where(mp.btype == BSDF_KISS, rough, 0.0)
