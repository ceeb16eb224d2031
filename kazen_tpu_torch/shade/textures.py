"""Texture evaluation over the flat texel pool (texture.cpp:46-270).

The port of ``kazen_tpu/shade/textures.py``. Every texture lives on the
device up front; a lookup is a bilinear fetch with periodic wrap and the
reference's v-flip and uv scale (texture.cpp:55: st = (u*scale,
(1-v)*scale)). sRGB images are linearized by the scene compiler at load
time. With mip filtering on, the lookup is trilinear across the image's
box-filtered chain at the level of the footprint's minor axis, and with
anisotropy it averages ``N_ANISO_PROBES`` such probes along the major axis
(EWA-style minification, as OIIO filters for the reference,
texture.cpp:46-64). Composite nodes (colorramp, blend) nest up to two
levels.
"""
from __future__ import annotations

import math

import torch

from ..core import math as km

N_ANISO_PROBES = 4  # texture probes along the footprint's major axis


def _bilinear_wh(pool, off, w, h, x, y):
    """Bilinear fetch at continuous texel coordinates (x, y) with periodic
    wrap, from the image at ``off`` of size w x h (per lane)."""
    x = x - 0.5
    y = y - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    x0i = torch.remainder(x0i, w)
    y0i = torch.remainder(y0i, h)
    c00 = pool.texels[off + y0i * w + x0i]
    c10 = pool.texels[off + y0i * w + x1i]
    c01 = pool.texels[off + y1i * w + x0i]
    c11 = pool.texels[off + y1i * w + x1i]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _bilinear_level(pool, tid, u, v, level):
    """Bilinear at the per-lane mip ``level``: its size is max(1, w >> l) x
    max(1, h >> l), at pool.mip_offset[tid, l]."""
    w = torch.clamp(pool.width[tid] >> level, min=1)
    h = torch.clamp(pool.height[tid] >> level, min=1)
    off = pool.mip_offset[tid, level]
    return _bilinear_wh(pool, off, w, h, u * w.to(torch.float32), v * h.to(torch.float32))


def _eval_leaf(pool, tid, uv, lod=None, aniso=None):
    """An image node (bilinear, or trilinear across its chain when ``lod``
    is given) or a constant; a composite node gives 0. ``lod`` is log2 of
    the uv-space footprint (the texture's own log2(resolution * scale) is
    added here); ``aniso`` the major uv half-axis, along which
    N_ANISO_PROBES trilinear probes are averaged (a zero half-axis puts
    them all on one spot: plain trilinear)."""
    from ..scene.compiler import TEX_CONSTANT, TEX_IMAGE

    scale = pool.uv_scale[tid]
    if lod is None:
        u = uv[..., 0] * scale
        v = (1.0 - uv[..., 1]) * scale
        w, h = pool.width[tid], pool.height[tid]
        img = _bilinear_wh(
            pool, pool.offset[tid], w, h, u * w.to(torch.float32), v * h.to(torch.float32)
        )
    else:
        # clamp the level of detail to the image's chain and blend the two
        # levels that bracket it
        res = torch.maximum(pool.width[tid], pool.height[tid]).to(torch.float32)
        lam = lod + torch.log2(res * torch.clamp(scale, min=1e-9))
        max_l = (pool.n_levels[tid] - 1).to(torch.float32)
        lam = torch.minimum(torch.clamp(lam, min=0.0), max_l)
        l0 = torch.floor(lam).to(torch.int64)
        l1 = torch.minimum(l0 + 1, pool.n_levels[tid] - 1)
        f = (lam - l0.to(torch.float32))[..., None]

        def trilinear(uv2):
            u = uv2[..., 0] * scale
            v = (1.0 - uv2[..., 1]) * scale
            return (1.0 - f) * _bilinear_level(pool, tid, u, v, l0) + (
                f * _bilinear_level(pool, tid, u, v, l1)
            )

        if aniso is None:
            img = trilinear(uv)
        else:
            img = 0.0
            for i in range(N_ANISO_PROBES):
                t = 2.0 * i / (N_ANISO_PROBES - 1) - 1.0  # [-1, 1]
                img = img + trilinear(uv + t * aniso)
            img = img / N_ANISO_PROBES
    tt = pool.ttype[tid]
    val = torch.where((tt == TEX_IMAGE)[..., None], img, 0.0)
    return torch.where((tt == TEX_CONSTANT)[..., None], pool.const_color[tid], val)


def _combine(pool, tid, child_eval):
    """One composite level: colorramp or blend over ``child_eval(node)``."""
    from ..scene.compiler import TEX_BLEND_MIX, TEX_BLEND_MULTIPLY, TEX_COLORRAMP

    tt = pool.ttype[tid]
    base = child_eval(tid)
    in1_id = pool.input1[tid]
    in2_id = pool.input2[tid]
    mask_id = pool.mask_id[tid]
    in1 = child_eval(torch.clamp(in1_id, min=0))
    in2 = child_eval(torch.clamp(in2_id, min=0))
    mask = child_eval(torch.clamp(mask_id, min=0))

    # colorramp (texture.cpp:160-170): per channel min + (max - min) *
    # clamp(c); a missing input gives 0
    ramped = pool.ramp_min[tid][..., None] + (
        pool.ramp_max[tid] - pool.ramp_min[tid]
    )[..., None] * torch.clamp(in1, 0.0, 1.0)
    ramped = torch.where((in1_id >= 0)[..., None], ramped, 0.0)

    # blend defaults (texture.cpp:208-216): mask 0.5, input1 0, input2 1
    b_in1 = torch.where((in1_id >= 0)[..., None], in1, 0.0)
    b_in2 = torch.where((in2_id >= 0)[..., None], in2, 1.0)
    b_mask = torch.where((mask_id >= 0)[..., None], mask, 0.5)[..., 0:1]
    mixed = (1.0 - b_mask) * b_in1 + b_mask * b_in2
    multiplied = b_in1 * b_in2

    out = base
    out = torch.where((tt == TEX_COLORRAMP)[..., None], ramped, out)
    out = torch.where((tt == TEX_BLEND_MIX)[..., None], mixed, out)
    return torch.where((tt == TEX_BLEND_MULTIPLY)[..., None], multiplied, out)


def textured(static, field=None) -> bool:
    """Whether material lookups of texture ``field`` (a key of the
    compiler's TEXTURE_FIELDS; None: of any field) may read the texture
    graph: the scene holds an image or composite node, and some material
    names a texture in that field (``static.textured_fields``). Otherwise
    every lane's value is the material row's constant, which is what
    eval_texture would select."""
    if not (static.has_image_textures or static.has_composite_textures):
        return False
    fields = static.textured_fields
    return bool(fields) if field is None else field in fields


def eval_texture(static, pool, tex_id, uv, const_color, lod=None):
    """Texture<Color3f>::eval(uv) over the texture graph: the node's value
    where ``tex_id >= 0``, else the per-lane ``const_color`` (N, 3).
    ``lod``: per-lane log2 uv footprint for mip selection (None: level-0
    bilinear). An (N, 3) ``uv`` carries the lod in its third column, an
    (N, 5) one also the anisotropic major uv half-axis in columns 3-4: the
    form in which the shading context threads the footprint to every
    fetch."""
    if not static.has_composite_textures and not static.has_image_textures:
        # only constant nodes exist, and the compiler folds every constant
        # a material or the background names into its row (texture id -1)
        return const_color
    aniso = None
    if uv.shape[-1] >= 3:
        if lod is None:
            lod = uv[..., 2]
        if uv.shape[-1] >= 5:
            aniso = uv[..., 3:5]
        uv = uv[..., :2]
    if not getattr(static, "mip_textures", False):
        lod = None
        aniso = None
    tid = torch.clamp(tex_id, min=0)
    if not static.has_composite_textures:
        val = _eval_leaf(pool, tid, uv, lod, aniso)
    else:
        def level1(nid):
            return _combine(pool, nid, lambda cid: _eval_leaf(pool, cid, uv, lod, aniso))

        val = _combine(pool, tid, level1)
    return torch.where((tex_id >= 0)[..., None], val, const_color)


def dir_to_uv(d):
    """Blinn/Newell lat-long mapping, the convention the reference intends
    (scene.cpp:58-63): u = (atan2(x, z) + pi) / 2pi, v = (asin(y) + pi/2) / pi."""
    u = (torch.atan2(d[..., 0], d[..., 2]) + math.pi) * km.INV_TWOPI
    v = (torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) + 0.5 * math.pi) * km.INV_PI
    return u, v


def eval_texture_dir(static, pool, tex_id, d, const_color, lod=None):
    """Directional (environment) lookup through the lat-long mapping;
    ``lod`` as in eval_texture."""
    return eval_texture(static, pool, tex_id, torch.stack(dir_to_uv(d), -1), const_color, lod=lod)
