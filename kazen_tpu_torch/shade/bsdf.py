"""BSDFs as functions over per-lane shade batches (bsdf.cpp).

The port of ``kazen_tpu/shade/bsdf.py``: diffuse, lambertian, mirror,
dielectric, GGX, roughconductor, roughplastic, roughdielectric, kiss
(KazenStandardSurface, bsdf.cpp:1157-1418) and the normalmap wrapper
(bsdf.cpp:281-417), with textured parameters. Conventions follow
bsdf.h:58-127: directions are in the local shading frame; ``eval`` returns
f*cos(theta_o); ``pdf`` is w.r.t. solid angle and 0 for discrete lobes;
``sample`` returns the weight f*cos/pdf.

Per-lane dispatch runs every material type present in the scene
(``static.btypes_present``) on the whole batch under a mask, as the
reference does. The normalmap wrapper is resolved once per hit in the
shading context: it perturbs the shading frame from its tangent-space
normal texture and hands re-expressed directions to the nested material.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as km
from ..core import warp
from ..core.math import Frame
from ..scene.compiler import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_GGX,
    BSDF_KISS,
    BSDF_LAMBERTIAN,
    BSDF_MIRROR,
    BSDF_NORMALMAP,
    BSDF_ROUGHCONDUCTOR,
    BSDF_ROUGHDIELECTRIC,
    BSDF_ROUGHPLASTIC,
    TEXTURE_FIELDS,
    MaterialTable,
)
from ..utils import metrics
from . import ggx
from .textures import eval_texture, textured

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


_BASE_BTYPES = (
    BSDF_DIFFUSE, BSDF_DIELECTRIC, BSDF_MIRROR, BSDF_LAMBERTIAN, BSDF_GGX,
    BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC, BSDF_ROUGHDIELECTRIC, BSDF_KISS,
)


def _base_types(static):
    """The material types the dispatch runs (the normalmap wrapper is
    resolved before it)."""
    types = tuple(t for t in static.btypes_present if t != BSDF_NORMALMAP)
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


def _field_textured(static, field):
    """The route of one lookup of material texture ``field``: True for the
    texture graph, False where no material textures the field and the rows'
    constants are every lane's value (textures.textured). The tracer counts
    the lookup by route."""
    image = textured(static, field)
    metrics.texture_lookup(field, "image" if image else "constant")
    return image


def _material_texture(static, tex, mp, field, uv):
    """Material parameter ``field`` ("base", "metallic" or "roughness") per
    lane: its texture where the lane's material names one, else the row's
    constant (``base_color``, ``metallic``, ``roughness``); a scalar
    parameter reads its texture's first channel."""
    const = mp.base_color if field == "base" else getattr(mp, field)
    if not _field_textured(static, field):
        return const
    tex_id = getattr(mp, TEXTURE_FIELDS[field])
    if field == "base":
        return eval_texture(static, tex, tex_id, uv, const)
    return eval_texture(static, tex, tex_id, uv, torch.stack([const] * 3, -1))[..., 0]


# ---------------------------------------------------------------------------
# diffuse (bsdf.cpp:63-106) and lambertian (bsdf.cpp:202-276)
# ---------------------------------------------------------------------------


def _albedo(static, tex, mp, uv, btype):
    """diffuse keeps a constant albedo; lambertian reads its albedo
    texture."""
    if btype == BSDF_LAMBERTIAN:
        return _material_texture(static, tex, mp, "base", uv)
    return mp.base_color


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
# mirror (bsdf.cpp:161-196) and dielectric (bsdf.cpp:98-155): discrete lobes
# ---------------------------------------------------------------------------


def _reflect_z(wi):
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)


def _discrete(n, device):
    return torch.zeros(n, device=device), torch.ones(n, dtype=torch.bool, device=device)


def _mirror_sample(wi):
    w = _mask3(_cos(wi) > 0.0, torch.ones_like(wi))
    pdf, disc = _discrete(wi.shape[:-1], wi.device)
    return _reflect_z(wi), w, torch.ones_like(pdf), disc, pdf


def _dielectric_sample(mp, wi, s1):
    """Fresnel-weighted choice between reflection and refraction
    (bsdf.cpp:118-142); the weight is 1 either way."""
    cos_i = _cos(wi)
    f = km.fresnel(cos_i, mp.ext_ior, mp.int_ior)
    outside = cos_i >= 0.0
    zero = torch.zeros_like(cos_i)
    n = km.vec3(zero, zero, torch.where(outside, 1.0, -1.0))
    factor = torch.where(outside, mp.int_ior / mp.ext_ior, mp.ext_ior / mp.int_ior)
    refracted = km.refract(-wi, n, factor)
    choose_reflect = s1 < f
    wo = torch.where(choose_reflect[..., None], _reflect_z(wi), refracted)
    eta = torch.where(choose_reflect, 1.0, mp.int_ior / mp.ext_ior)
    pdf, disc = _discrete(cos_i.shape, wi.device)
    return wo, torch.ones_like(wi), eta, disc, pdf


# ---------------------------------------------------------------------------
# ggx (bsdf.cpp:629-689): GGX-Smith VNDF BRDF
# ---------------------------------------------------------------------------


def _ggx_eval(static, tex, mp, uv, wi, wo):
    albedo = _material_texture(static, tex, mp, "base", uv)
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
# roughconductor (bsdf.cpp:692-790), roughplastic (:800-930) and
# roughdielectric (:940-1140): Beckmann microfacets
# ---------------------------------------------------------------------------


def _sample_result(wo, w, pdf, eta=None):
    """A non-discrete sample's SampleResult fields (eta 1 unless given)."""
    n = wo.shape[:-1]
    if eta is None:
        eta = torch.ones(n, device=wo.device)
    return wo, w, eta, torch.zeros(n, dtype=torch.bool, device=wo.device), pdf


def _safe_wh(wi, wo):
    """The half-vector, with +z on lanes where it is undefined (either
    direction below the surface, or wi ~ -wo): every rough* branch runs on
    all lanes and is masked afterwards. Returns (wh, ok)."""
    h = wi + wo
    n2 = km.dot(h, h)
    ok = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (n2 > 1e-12)
    z = torch.zeros_like(h)
    z[..., 2] = 1.0
    h = torch.where(ok[..., None], h, z)
    return h / km.norm(h, keepdims=True), ok


def _roughconductor_eval(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    f = ggx.fresnel_conductor(km.dot(wh, wo), mp.eta_c, mp.k_c)
    d = ggx.beckmann_ndf(wh, mp.alpha)
    g = ggx.smith_beckmann_g1(wi, wh, mp.alpha) * ggx.smith_beckmann_g1(wo, wh, mp.alpha)
    val = (d * g / torch.clamp(4.0 * _cos(wi), min=1e-9))[..., None] * f
    return _mask3(m, val)


def _roughconductor_pdf(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = ggx.beckmann_ndf(wh, mp.alpha)
    denom = 4.0 * km.dot(wh, wo)
    safe = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    return torch.where(m, d * _cos(wh) / safe, 0.0)


def _roughconductor_sample(mp, wi, s2):
    wh = warp.square_to_beckmann(s2, mp.alpha)
    wo = km.normalize(km.reflect(wi, wh))
    val = _roughconductor_eval(mp, wi, wo)
    pdf = _roughconductor_pdf(mp, wi, wo)
    w = val / torch.clamp(pdf, min=1e-9)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (pdf > 0.0)
    return _sample_result(wo, _mask3(m, w), pdf)


def _roughplastic_ks(mp):
    return 1.0 - mp.base_color.amax(dim=-1)


def _roughplastic_eval(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = ggx.beckmann_ndf(wh, mp.alpha)
    f = km.fresnel(km.dot(wh, wo), mp.ext_ior, mp.int_ior)
    g = ggx.smith_beckmann_g1(wo, wh, mp.alpha) * ggx.smith_beckmann_g1(wi, wh, mp.alpha)
    ks = _roughplastic_ks(mp)
    spec = ks * d * f * g / torch.clamp(4.0 * _cos(wi), min=1e-9)
    val = mp.base_color * (km.INV_PI * _cos(wo))[..., None] + spec[..., None]
    return _mask3(m, val)


def _roughplastic_pdf(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = ggx.beckmann_ndf(wh, mp.alpha)
    jh = 1.0 / torch.clamp(4.0 * torch.abs(km.dot(wh, wo)), min=1e-9)
    ks = _roughplastic_ks(mp)
    pdf = ks * d * _cos(wh) * jh + (1.0 - ks) * _cos(wo) * km.INV_PI
    return torch.where(m, pdf, 0.0)


def _roughplastic_sample(mp, wi, s1, s2):
    ks = _roughplastic_ks(mp)
    wh = warp.square_to_beckmann(s2, mp.alpha)
    wo_spec = km.normalize(2.0 * km.dot(wh, wi, keepdims=True) * wh - wi)
    wo_diff = warp.square_to_cosine_hemisphere(s2)
    wo = torch.where((s1 < ks)[..., None], wo_spec, wo_diff)
    val = _roughplastic_eval(mp, wi, wo)
    pdf = _roughplastic_pdf(mp, wi, wo)
    w = val / torch.clamp(pdf, min=1e-9)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (pdf > 0.0)
    return _sample_result(wo, _mask3(m, w), pdf)


def _rd_refract(wi, n, eta, cos_theta_t):
    """RoughDielectric::refract (bsdf.cpp:1129-1134)."""
    eta_eff = torch.where(cos_theta_t < 0.0, 1.0 / eta, eta)
    return n * (km.dot(wi, n) * eta_eff + cos_theta_t)[..., None] - wi * eta_eff[..., None]


def _rd_half(mp, wi, wo):
    """(is_reflect, eta, eta0, wm unflipped) of roughdielectric's eval and
    pdf (bsdf.cpp:966-1047)."""
    cos_i = _cos(wi)
    eta0 = mp.int_ior / mp.ext_ior
    is_reflect = cos_i * _cos(wo) > 0.0
    eta = torch.where(cos_i > 0.0, eta0, mp.ext_ior / mp.int_ior)
    wm = km.normalize(torch.where(is_reflect[..., None], wi + wo, wi + wo * eta[..., None]))
    return is_reflect, eta, eta0, wm


def _roughdielectric_eval(mp, wi, wo):
    """bsdf.cpp:966-1010."""
    cos_i = _cos(wi)
    is_reflect, eta, eta0, wm = _rd_half(mp, wi, wo)
    wm = wm * torch.sign(_cos(wm))[..., None]
    f, _ = km.fresnel_dielectric(km.dot(wi, wm), eta0)
    d = ggx.beckmann_ndf(wm, mp.alpha)
    g = ggx.smith_beckmann_g1(wo, wm, mp.alpha) * ggx.smith_beckmann_g1(wi, wm, mp.alpha)
    fr = f * g * d / torch.clamp(4.0 * torch.abs(cos_i), min=1e-9)
    denom = km.dot(wi, wm) + eta * km.dot(wo, wm)
    cd2 = cos_i * km.sqr(denom)
    ft = torch.abs(
        (1.0 - f) * d * g * eta * eta * km.dot(wi, wm) * km.dot(wo, wm)
        / torch.where(cd2 == 0.0, 1e-9, cd2)
    )
    val = torch.where(is_reflect, fr, ft)
    val = torch.where(cos_i == 0.0, 0.0, val)
    return val[..., None] * torch.ones_like(wi)


def _roughdielectric_pdf(mp, wi, wo):
    """bsdf.cpp:1012-1047."""
    is_reflect, eta, eta0, wm = _rd_half(mp, wi, wo)
    dwm_r = 1.0 / torch.where(km.dot(wo, wm) == 0.0, 1e-9, 4.0 * km.dot(wo, wm))
    sqrt_denom = km.dot(wi, wm) + eta * km.dot(wo, wm)
    dwm_t = (eta * eta * km.dot(wo, wm)) / torch.clamp(km.sqr(sqrt_denom), min=1e-9)
    dwm_dwo = torch.where(is_reflect, dwm_r, dwm_t)
    wm = wm * torch.sign(_cos(wm))[..., None]
    f, _ = km.fresnel_dielectric(km.dot(wi, wm), eta0)
    d = ggx.beckmann_ndf(wm, mp.alpha)
    prob = d * _cos(wm) * torch.where(is_reflect, f, 1.0 - f)
    return torch.abs(prob * dwm_dwo)


def _roughdielectric_sample(mp, wi, s1, s2):
    """bsdf.cpp:1051-1095, with Walter's alpha scaling for the sampled
    normal; the pdf returned is the one pdf() gives (the class alpha)."""
    cos_i = _cos(wi)
    eta0 = mp.int_ior / mp.ext_ior
    alpha = mp.alpha * (1.2 - 0.2 * torch.sqrt(torch.abs(cos_i)))
    wm = warp.square_to_beckmann(s2, alpha)
    pdf_m = warp.square_to_beckmann_pdf(wm, alpha)
    f, cos_theta_t = km.fresnel_dielectric(km.dot(wi, wm), eta0)
    sample_reflection = s1 <= f
    wo = torch.where(
        sample_reflection[..., None], km.reflect(wi, wm), _rd_refract(wi, wm, eta0, cos_theta_t)
    )
    eta = torch.where(
        sample_reflection, 1.0, torch.where(cos_theta_t < 0.0, eta0, mp.ext_ior / mp.int_ior)
    )
    cos_o = _cos(wo)
    ok = torch.where(
        sample_reflection, cos_i * cos_o > 0.0, (cos_i * cos_o < 0.0) & (cos_theta_t != 0.0)
    ) & (pdf_m > 0.0)
    d = ggx.beckmann_ndf(wm, alpha)
    g = ggx.smith_beckmann_g1(wo, wm, alpha) * ggx.smith_beckmann_g1(wi, wm, alpha)
    pc = pdf_m * cos_i
    w = torch.abs(d * g * km.dot(wi, wm) / torch.where(pc == 0.0, 1e-9, pc))
    w3 = _mask3(ok, w[..., None] * torch.ones_like(wi))
    return _sample_result(wo, w3, _roughdielectric_pdf(mp, wi, wo), eta)


# ---------------------------------------------------------------------------
# kiss / KazenStandardSurface (bsdf.cpp:1157-1418)
# ---------------------------------------------------------------------------


def _kiss_textures(static, tex, mp, uv):
    return tuple(_material_texture(static, tex, mp, field, uv)
                 for field in ("base", "metallic", "roughness"))


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
        if t in (BSDF_DIFFUSE, BSDF_LAMBERTIAN):
            f = _diffuse_eval(_albedo(static, tex, mp, uv, t), wi, wo)
            p = _diffuse_pdf(wi, wo)
        elif t in (BSDF_MIRROR, BSDF_DIELECTRIC):
            f = torch.zeros_like(wi)
            p = torch.zeros(wi.shape[:-1], device=wi.device)
        elif t == BSDF_GGX:
            f = _ggx_eval(static, tex, mp, uv, wi, wo)
            p = _ggx_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHCONDUCTOR:
            f, p = _roughconductor_eval(mp, wi, wo), _roughconductor_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHPLASTIC:
            f, p = _roughplastic_eval(mp, wi, wo), _roughplastic_pdf(mp, wi, wo)
        elif t == BSDF_ROUGHDIELECTRIC:
            f, p = _roughdielectric_eval(mp, wi, wo), _roughdielectric_pdf(mp, wi, wo)
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
        if t in (BSDF_DIFFUSE, BSDF_LAMBERTIAN):
            res = _diffuse_sample(_albedo(static, tex, mp, uv, t), wi, s2)
        elif t == BSDF_MIRROR:
            res = _mirror_sample(wi)
        elif t == BSDF_DIELECTRIC:
            res = _dielectric_sample(mp, wi, s1)
        elif t == BSDF_GGX:
            res = _ggx_sample(static, tex, mp, uv, wi, s2)
        elif t == BSDF_ROUGHCONDUCTOR:
            res = _roughconductor_sample(mp, wi, s2)
        elif t == BSDF_ROUGHPLASTIC:
            res = _roughplastic_sample(mp, wi, s1, s2)
        elif t == BSDF_ROUGHDIELECTRIC:
            res = _roughdielectric_sample(mp, wi, s1, s2)
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
# the shading context, with the normalmap wrapper resolved (bsdf.cpp:281-417)
# ---------------------------------------------------------------------------


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


def make_ctx(static, scene, mat_id, uv, sh_frame, wi, dpdu=None, lod=None,
             aniso=None) -> ShadeCtx:
    """The shading context of hits on materials ``mat_id``. ``dpdu`` (the
    hit's surface tangent) is needed where a normalmap is present; ``lod``
    and ``aniso`` (path_mis._texture_footprint) thread the mip footprint to
    every texture fetch as extra uv columns [u, v, lod, maj_du, maj_dv]."""
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
    if dpdu is None:
        raise ValueError("a scene with a normal map needs the hits' dpdu")
    is_nm = mp.btype == BSDF_NORMALMAP
    mp_eff = scene.materials.rows(torch.where(is_nm, mp.nested, mat_id))
    if _field_textured(static, "normal"):
        with metrics.sync("shade/bsdf.py:make_ctx torch.tensor"):
            flat = torch.tensor([0.5, 0.5, 1.0], dtype=wi.dtype, device=wi.device)
        rgb = eval_texture(static, tex, mp.tex_normal, uv, flat.expand_as(wi))
    else:  # the flat (0.5, 0.5, 1) on every lane
        rgb = torch.full_like(wi, 0.5)
        rgb[..., 2] = 1.0
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


def eval_ctx(static, ctx: ShadeCtx, wo, accum_rough):
    return eval_pdf_ctx(static, ctx, wo, accum_rough)[0]


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
    rough = _material_texture(static, ctx.textures, mp, "roughness", ctx.uv)
    return torch.where(mp.btype == BSDF_KISS, rough, 0.0)


# thin wrappers by material id (the debug integrators)


def eval(static, scene, mat_id, uv, sh_frame, dpdu, wi, wo, accum_rough):
    """BSDF::eval with per-lane dispatch and the normalmap wrapper; wi and wo
    in the hit's shading frame; returns f*cos(theta_o)."""
    return eval_ctx(static, make_ctx(static, scene, mat_id, uv, sh_frame, wi, dpdu), wo,
                    accum_rough)


def sample(static, scene, mat_id, uv, sh_frame, dpdu, wi, s1, s2, accum_rough) -> SampleResult:
    return sample_ctx(static, make_ctx(static, scene, mat_id, uv, sh_frame, wi, dpdu), s1, s2,
                      accum_rough)
