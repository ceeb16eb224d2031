"""The Beckmann lobes of roughconductor (bsdf.cpp:692-790), roughplastic
(:800-930) and roughdielectric (:940-1140): frozen copies of the port's
``shade/bsdf.py`` rough* functions and the pieces they call
(``shade/ggx.py``'s Beckmann NDF, Smith G1 and conductor Fresnel,
``core/warp.py``'s Beckmann warp and pdf, ``core/math.py``'s dielectric
Fresnel terms). Directions are in the local shading frame; an eval returns
f * cos(theta_o), a pdf is with respect to solid angle, a sample returns
(wo, weight, eta, discrete, pdf)."""
from __future__ import annotations

import math as pymath

import torch

from ..kz.core import math as km
from ..kz.core.warp import square_to_cosine_hemisphere
from ..kz.shade.bsdf import _cos, _mask3


def fresnel(cos_theta_i, ext_ior, int_ior):
    """Unpolarized dielectric Fresnel reflectance (common.cpp:447-476)."""
    enter = cos_theta_i >= 0.0
    eta_i = torch.where(enter, ext_ior, int_ior)
    eta_t = torch.where(enter, int_ior, ext_ior)
    ci = torch.abs(cos_theta_i)
    eta = eta_i / eta_t
    sin_t2 = eta * eta * (1.0 - ci * ci)
    ok = sin_t2 < 1.0
    ct = torch.sqrt(torch.where(ok, 1.0 - sin_t2, 1.0))
    rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct)
    rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct)
    f = torch.where(ok, 0.5 * (rs * rs + rp * rp), 1.0)
    return torch.where(ext_ior == int_ior, 0.0, f)


def fresnel_dielectric(cos_theta_i, eta):
    """fresnelDielectric with cosThetaT out (common.cpp:491-517); eta =
    int_ior / ext_ior. Returns (F, cos_theta_t)."""
    scale = torch.where(cos_theta_i > 0.0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * (scale * scale)
    ci = torch.abs(cos_theta_i)
    ok = cos_t2 > 0.0
    ct = torch.sqrt(torch.where(ok, cos_t2, 1.0))
    rs = (ci - eta * ct) / (ci + eta * ct)
    rp = (eta * ci - ct) / (eta * ci + ct)
    f = torch.where(ok, 0.5 * (rs * rs + rp * rp), 1.0)
    cos_theta_t = torch.where(ok, torch.where(cos_theta_i > 0.0, -ct, ct), 0.0)
    return f, cos_theta_t


def square_to_beckmann(s, alpha):
    """Beckmann microfacet normal (warp.cpp:118-127)."""
    phi = 2.0 * pymath.pi * s[..., 0]
    theta = torch.atan(
        alpha * torch.sqrt(torch.log(1.0 / torch.clamp(1.0 - s[..., 1], min=1e-9)))
    )
    st, ct = torch.sin(theta), torch.cos(theta)
    return km.vec3(st * torch.cos(phi), st * torch.sin(phi), ct)


def square_to_beckmann_pdf(m, alpha):
    ct = torch.clamp(m[..., 2], -1.0, 1.0)
    tan2 = torch.clamp(1.0 - ct * ct, min=0.0) / torch.clamp(ct * ct, min=1e-9)
    pdf = torch.exp(-tan2 / (alpha * alpha)) / (
        pymath.pi * alpha * alpha * torch.clamp(ct, min=1e-9) ** 3
    )
    return torch.where(ct > 0.0, pdf, 0.0)


def beckmann_ndf(m, alpha):
    """evalBeckmann: exp(-tan^2 / a^2) / (pi a^2 cos^4)."""
    ct = m[..., 2]
    ct2 = torch.clamp(km.sqr(ct), min=1e-9)
    tan2 = torch.clamp(1.0 - km.sqr(ct), min=0.0) / ct2
    return torch.exp(-tan2 / km.sqr(alpha)) / (pymath.pi * km.sqr(alpha) * km.sqr(ct2))


def smith_beckmann_g1(v, m, alpha):
    """Rational approximation of Smith-Beckmann G1 (bsdf.cpp:737-757)."""
    ct = v[..., 2]
    tan_theta = torch.abs(
        torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0)) / torch.where(ct == 0.0, 1e-9, ct)
    )
    a = 1.0 / (alpha * torch.clamp(tan_theta, min=1e-2))
    a2 = a * a
    approx = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    g = torch.where((a >= 1.6) | (tan_theta == 0.0), 1.0, approx)
    return torch.where(km.dot(v, m) * ct <= 0.0, 0.0, g)


def fresnel_conductor(cos_theta_i, eta, k):
    """fresnelCond (bsdf.cpp:717-726); eta and k are (..., 3)."""
    ci = cos_theta_i[..., None]
    tmp_f = km.sqr(eta) + km.sqr(k)
    tmp = tmp_f * km.sqr(ci)
    rparl2 = (tmp - 2.0 * eta * ci + 1.0) / (tmp + 2.0 * eta * ci + 1.0)
    rperp2 = (tmp_f - 2.0 * eta * ci + km.sqr(ci)) / (tmp_f + 2.0 * eta * ci + km.sqr(ci))
    return (rparl2 + rperp2) / 2.0


def _sample_result(wo, w, pdf, eta=None):
    n = wo.shape[:-1]
    if eta is None:
        eta = torch.ones(n, device=wo.device)
    return wo, w, eta, torch.zeros(n, dtype=torch.bool, device=wo.device), pdf


def _safe_wh(wi, wo):
    """The half-vector, with +z on lanes where it is undefined. Returns
    (wh, ok)."""
    h = wi + wo
    n2 = km.dot(h, h)
    ok = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (n2 > 1e-12)
    z = torch.zeros_like(h)
    z[..., 2] = 1.0
    h = torch.where(ok[..., None], h, z)
    return h / km.norm(h, keepdims=True), ok


def roughconductor_eval(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    f = fresnel_conductor(km.dot(wh, wo), mp.eta_c, mp.k_c)
    d = beckmann_ndf(wh, mp.alpha)
    g = smith_beckmann_g1(wi, wh, mp.alpha) * smith_beckmann_g1(wo, wh, mp.alpha)
    val = (d * g / torch.clamp(4.0 * _cos(wi), min=1e-9))[..., None] * f
    return _mask3(m, val)


def roughconductor_pdf(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = beckmann_ndf(wh, mp.alpha)
    denom = 4.0 * km.dot(wh, wo)
    safe = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    return torch.where(m, d * _cos(wh) / safe, 0.0)


def roughconductor_sample(mp, wi, s2):
    wh = square_to_beckmann(s2, mp.alpha)
    wo = km.normalize(km.reflect(wi, wh))
    val = roughconductor_eval(mp, wi, wo)
    pdf = roughconductor_pdf(mp, wi, wo)
    w = val / torch.clamp(pdf, min=1e-9)[..., None]
    m = (_cos(wi) > 0.0) & (_cos(wo) > 0.0) & (pdf > 0.0)
    return _sample_result(wo, _mask3(m, w), pdf)


def _roughplastic_ks(mp):
    return 1.0 - mp.base_color.amax(dim=-1)


def roughplastic_eval(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = beckmann_ndf(wh, mp.alpha)
    f = fresnel(km.dot(wh, wo), mp.ext_ior, mp.int_ior)
    g = smith_beckmann_g1(wo, wh, mp.alpha) * smith_beckmann_g1(wi, wh, mp.alpha)
    ks = _roughplastic_ks(mp)
    spec = ks * d * f * g / torch.clamp(4.0 * _cos(wi), min=1e-9)
    val = mp.base_color * (km.INV_PI * _cos(wo))[..., None] + spec[..., None]
    return _mask3(m, val)


def roughplastic_pdf(mp, wi, wo):
    wh, m = _safe_wh(wi, wo)
    d = beckmann_ndf(wh, mp.alpha)
    jh = 1.0 / torch.clamp(4.0 * torch.abs(km.dot(wh, wo)), min=1e-9)
    ks = _roughplastic_ks(mp)
    pdf = ks * d * _cos(wh) * jh + (1.0 - ks) * _cos(wo) * km.INV_PI
    return torch.where(m, pdf, 0.0)


def roughplastic_sample(mp, wi, s1, s2):
    ks = _roughplastic_ks(mp)
    wh = square_to_beckmann(s2, mp.alpha)
    wo_spec = km.normalize(2.0 * km.dot(wh, wi, keepdims=True) * wh - wi)
    wo_diff = square_to_cosine_hemisphere(s2)
    wo = torch.where((s1 < ks)[..., None], wo_spec, wo_diff)
    val = roughplastic_eval(mp, wi, wo)
    pdf = roughplastic_pdf(mp, wi, wo)
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


def roughdielectric_eval(mp, wi, wo):
    """bsdf.cpp:966-1010."""
    cos_i = _cos(wi)
    is_reflect, eta, eta0, wm = _rd_half(mp, wi, wo)
    wm = wm * torch.sign(_cos(wm))[..., None]
    f, _ = fresnel_dielectric(km.dot(wi, wm), eta0)
    d = beckmann_ndf(wm, mp.alpha)
    g = smith_beckmann_g1(wo, wm, mp.alpha) * smith_beckmann_g1(wi, wm, mp.alpha)
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


def roughdielectric_pdf(mp, wi, wo):
    """bsdf.cpp:1012-1047."""
    is_reflect, eta, eta0, wm = _rd_half(mp, wi, wo)
    dwm_r = 1.0 / torch.where(km.dot(wo, wm) == 0.0, 1e-9, 4.0 * km.dot(wo, wm))
    sqrt_denom = km.dot(wi, wm) + eta * km.dot(wo, wm)
    dwm_t = (eta * eta * km.dot(wo, wm)) / torch.clamp(km.sqr(sqrt_denom), min=1e-9)
    dwm_dwo = torch.where(is_reflect, dwm_r, dwm_t)
    wm = wm * torch.sign(_cos(wm))[..., None]
    f, _ = fresnel_dielectric(km.dot(wi, wm), eta0)
    d = beckmann_ndf(wm, mp.alpha)
    prob = d * _cos(wm) * torch.where(is_reflect, f, 1.0 - f)
    return torch.abs(prob * dwm_dwo)


def roughdielectric_sample(mp, wi, s1, s2):
    """bsdf.cpp:1051-1095, with Walter's alpha scaling for the sampled
    normal; the pdf returned is the one pdf() gives (the class alpha)."""
    cos_i = _cos(wi)
    eta0 = mp.int_ior / mp.ext_ior
    alpha = mp.alpha * (1.2 - 0.2 * torch.sqrt(torch.abs(cos_i)))
    wm = square_to_beckmann(s2, alpha)
    pdf_m = square_to_beckmann_pdf(wm, alpha)
    f, cos_theta_t = fresnel_dielectric(km.dot(wi, wm), eta0)
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
    d = beckmann_ndf(wm, alpha)
    g = smith_beckmann_g1(wo, wm, alpha) * smith_beckmann_g1(wi, wm, alpha)
    pc = pdf_m * cos_i
    w = torch.abs(d * g * km.dot(wi, wm) / torch.where(pc == 0.0, 1e-9, pc))
    w3 = _mask3(ok, w[..., None] * torch.ones_like(wi))
    return _sample_result(wo, w3, roughdielectric_pdf(mp, wi, wo), eta)
