"""Discrete PDF over array entries (dpdf.h:14-169) as a prefix sum and a
sorted search.

The port of ``kazen_tpu/core/dpdf.py``: the CDF is a tensor built once;
sampling is one ``searchsorted`` per lane. The search is bisect-right, as
the reference's (dpdf.h:99-104): where a run of entries has zero weight and
so a flat CDF, it picks the last row that starts at or below ``u``, never a
zero-weight row before it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .device import resolve_device


class DiscretePDF(NamedTuple):
    cdf: torch.Tensor  # (n + 1,) inclusive prefix sums, cdf[0] = 0, cdf[-1] = 1
    normalization: torch.Tensor  # () 1 / sum of the unnormalized weights


def build(weights, device="cuda") -> DiscretePDF:
    """normalize() (dpdf.h:70-86), on ``device`` (the card unless the caller
    asks for the CPU)."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=resolve_device(device))
    cdf = torch.cat([torch.zeros(1, dtype=w.dtype, device=w.device), torch.cumsum(w, 0)])
    total = cdf[-1]
    return DiscretePDF(cdf=cdf / total, normalization=1.0 / total)


def build_np(weights) -> Tuple[np.ndarray, float]:
    w = np.asarray(weights, np.float32)
    cdf = np.concatenate([[0.0], np.cumsum(w, dtype=np.float64)]).astype(np.float32)
    total = float(cdf[-1])
    return cdf / total, 1.0 / total


def sample(d: DiscretePDF, u):
    """sample(u) -> index (dpdf.h:99-111): the largest i with cdf[i] <= u."""
    idx = torch.searchsorted(d.cdf, u, right=True) - 1
    return torch.clamp(idx, 0, d.cdf.shape[0] - 2)


def sample_reuse(d: DiscretePDF, u):
    """sampleReuse (dpdf.h:131-141): also rescale u within the chosen bin."""
    idx = sample(d, u)
    lo = d.cdf[idx]
    hi = d.cdf[idx + 1]
    return idx, (u - lo) / torch.clamp(hi - lo, min=1e-9)


def pdf_of(d: DiscretePDF, idx):
    return d.cdf[idx + 1] - d.cdf[idx]
