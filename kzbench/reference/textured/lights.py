"""Environment importance sampling (frozen copies of the port's
``shade/lights.py`` ``_bisect_rows``, ``sample_env_light`` and
``pdf_env_dir``): the compile-time tables pick a texel by its row marginal
and row conditional CDFs, with a continuous offset inside it; the
background along the direction is ``kz/``'s ``background_radiance``."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kz.shade.lights import background_radiance
from ..kz.shade.textures import dir_to_uv


class EnvSample(NamedTuple):
    wi: torch.Tensor  # (N, 3) unit direction toward the environment
    pdf: torch.Tensor  # (N,) solid-angle pdf
    radiance: torch.Tensor  # (N, 3) environment radiance along wi
    ls: torch.Tensor  # (N, 3) radiance / pdf (0 where the pdf is 0)


def _bisect_rows(cdf_2d, row, u, n):
    """Per-lane bisect-right over ``cdf_2d[row]`` (n + 1 entries): j with
    cdf[j] <= u < cdf[j + 1], in ceil(log2 n) steps of one gather each."""
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, n)
    for _ in range(int(np.ceil(np.log2(max(n, 2))))):
        mid = (lo + hi) // 2
        go_right = u >= cdf_2d[row, mid]
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def sample_env_light(scene, static, u1, u2) -> EnvSample:
    """Importance-sample the environment: u1 inverts the row marginal CDF,
    u2 the row's conditional."""
    eh, ew = static.env_res
    row_cdf = scene.env_row_cdf  # (Eh + 1,)
    col_cdf = scene.env_col_cdf  # (Eh, Ew + 1)

    i = torch.clamp(torch.searchsorted(row_cdf, u1, right=True) - 1, 0, eh - 1)
    seg = torch.clamp(row_cdf[i + 1] - row_cdf[i], min=1e-12)
    dv = torch.clamp((u1 - row_cdf[i]) / seg, 0.0, 1.0)
    v = (i.to(torch.float32) + dv) / eh

    j = _bisect_rows(col_cdf, i, u2, ew)
    segc = torch.clamp(col_cdf[i, j + 1] - col_cdf[i, j], min=1e-12)
    du = torch.clamp((u2 - col_cdf[i, j]) / segc, 0.0, 1.0)
    u = (j.to(torch.float32) + du) / ew

    phi = u * (2.0 * math.pi) - math.pi
    lat = (v - 0.5) * math.pi
    cos_lat = torch.cos(lat)
    wi = torch.stack([cos_lat * torch.sin(phi), torch.sin(lat), cos_lat * torch.cos(phi)], -1)
    pdf = scene.env_pdf[i, j]
    radiance = background_radiance(scene, static, wi)
    ls = torch.where(
        (pdf > 0.0)[:, None], radiance / torch.clamp(pdf, min=1e-12)[:, None], 0.0
    )
    return EnvSample(wi=wi, pdf=pdf, radiance=radiance, ls=ls)


def pdf_env_dir(scene, static, d):
    """The solid-angle pdf the environment sampler gives direction ``d``
    (for MIS against BSDF sampling)."""
    eh, ew = static.env_res
    u, v = dir_to_uv(d)
    i = torch.clamp((v * eh).to(torch.int64), 0, eh - 1)
    j = torch.clamp((u * ew).to(torch.int64), 0, ew - 1)
    return scene.env_pdf[i, j]
