"""K6: the port of ``benchmarks/visit_lab.py``, simulated cluster-trace leaf
visits.

``make_drain(...)`` returns ``(run, geo)`` as the original does: ``run(geo)``
gives the (8, blocks * 1024) rows of one launch over ``blocks`` blocks of
BLOCK = 1024 lanes. Each block runs ``visits`` visits; visit i reads
geo[cid] (cid = (7 b + 13 i) mod 256), forms det, tn, un, vn for K_tri
columns as products over its F rows against the lane's ``feat`` column
(``quantities_packed`` 1: four depth-16 products of w, w+1, w+2, w+3; 4: one
depth-64 product whose 4 K_tri columns are the four quantities), runs the
acceptance chain (``mxu_lab.chain_plain``) and keeps the least tt. With the
fetch, a lane whose least tt beats row 0 takes it, and row 1 takes row 0 of
the buffer at the lane's argmin; without it row 0 keeps the running min.

Precision as in ``mxu_lab``; with bf16 geo the sums w + j are rounded to
bf16 too. The original reads two things it never wrote, and the port
defines them: without the copy (``with_dma=False``) the buffer holds geo[0];
``feat`` is ones in every block. Row 0 starts at 0 and every accepted tt is
>= 0, so the fetch branch never runs and every output is 0 on every geo;
``run(geo, diag=True)`` also returns per lane the count of accepted tests,
the least accepted tt (3e38 when none) and the fetches taken.

On the card the precision picks the design (``csrc/lab.cu``): DEFAULT and
bf16 geo run the visit's products on the tensor cores (bf16 ``wgmma`` from
shared memory, f32 sums), f32 geo at HIGHEST on an f32 SIMT loop.

``main()`` runs the original's 8 configurations at blocks = 506, visits =
40: ``python -m kazen_tpu_torch.lab.visit_lab [--device cpu]`` (on the CPU,
``main("cpu", blocks=1, visits=1)`` runs the plain versions small).
"""
from __future__ import annotations

import argparse

import torch

from ..core.device import resolve_device
from ..cuda_build import CudaKernel
from . import device_name, library, raise_on, timed
from .mxu_lab import BIG, PRECISIONS, chain_plain, round_bf16

BLOCK = 1024
GEO_SLOTS = 256
DRAIN_PROBE = CudaKernel("drain_probe", "benchmarks/visit_lab.py:45")
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper

# the original's table (benchmarks/visit_lab.py:main):
# (label, quantities_packed, K_tri, precision, bf16, with_fetch, with_dma)
BLOCKS = 506
VISITS = 40
CONFIGS = (
    ("current: 4x(16,128) HIGHEST +fetch +dma", 1, 128, "HIGHEST", False, True, True),
    ("4x(16,128) HIGHEST, no fetch, no dma   ", 1, 128, "HIGHEST", False, False, False),
    ("4x(16,128) DEFAULT +fetch +dma         ", 1, 128, "DEFAULT", False, True, True),
    ("packed (64,512) HIGHEST +fetch +dma    ", 4, 128, "HIGHEST", False, True, True),
    ("packed (64,512) DEFAULT +fetch +dma    ", 4, 128, "DEFAULT", False, True, True),
    ("packed (64,512) bf16 +fetch +dma       ", 4, 128, "DEFAULT", True, True, True),
    ("packed (64,512) bf16, no fetch +dma    ", 4, 128, "DEFAULT", True, False, True),
    ("packed K=64 (64,256) bf16 +fetch +dma  ", 4, 64, "DEFAULT", True, True, True),
)


def geo_shape(quantities_packed: int, K_tri: int) -> tuple:
    """The original's geo: 256 slots of (16 qp, max(K_tri qp, 128))."""
    return (GEO_SLOTS, 16 * quantities_packed, max(K_tri * quantities_packed, 128))


def _check(geo, visits, qp, K, precision, blocks) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if qp not in (1, 4):
        raise ValueError(f"quantities_packed must be 1 or 4, got {qp}")
    smem = (16 * qp * 4 * K + K) * 4
    if K < 4 or K % 4 or smem > SMEM_LIMIT:
        raise ValueError(f"K_tri must be a multiple of 4 whose tile fits {SMEM_LIMIT} bytes "
                         f"of shared memory, got {K} ({smem} bytes)")
    if geo.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"geo must be float32 or bfloat16, got {geo.dtype}")
    if (geo.dim() != 3 or geo.shape[0] != GEO_SLOTS or geo.shape[1] != 16 * qp
            or geo.shape[2] < K * qp or geo.shape[2] % 4):
        raise ValueError(f"geo must be ({GEO_SLOTS}, {16 * qp}, width >= {K * qp}, a multiple "
                         f"of 4), got {tuple(geo.shape)}")
    if visits < 0 or blocks < 1 or blocks * BLOCK >= 2**31:
        raise ValueError(f"bad visits {visits} or blocks {blocks}")


def _operands(slots: torch.Tensor, qp: int, K: int, round_ops: bool) -> torch.Tensor:
    """(..., F, 4K) f32 operand tiles of geo slots (..., F, width): column
    block j is quantity j's operand (the kernel's tile)."""
    w = slots[..., :K * qp].to(torch.float32)
    if qp == 1:
        w = torch.cat([w] + [w + float(j) for j in (1, 2, 3)], dim=-1)
    return round_bf16(w) if round_ops else w


def drain_plain(geo, visits, quantities_packed, K_tri, precision, with_fetch, with_dma, blocks,
                diag=False):
    """The plain version of K6: (8, blocks * 1024) f32, or (out, count,
    tmin, fetches) with ``diag``. The sums run over the F rows one after
    another, in the kernel's order."""
    qp, K = quantities_packed, K_tri
    _check(geo, visits, qp, K, precision, blocks)
    dev = geo.device
    F = 16 * qp
    round_ops = precision == "DEFAULT" or geo.dtype == torch.bfloat16
    feat = torch.ones((F, BLOCK), dtype=geo.dtype, device=dev).to(torch.float32)
    if round_ops:
        feat = round_bf16(feat)
    bid = torch.arange(blocks, device=dev)
    acc0 = torch.zeros((blocks, BLOCK), dtype=torch.float32, device=dev)
    acc1 = torch.zeros_like(acc0)
    count = torch.zeros((blocks, BLOCK), dtype=torch.int32, device=dev)
    tmin = torch.full((blocks, BLOCK), BIG, dtype=torch.float32, device=dev)
    taken = torch.zeros((blocks, 1), dtype=torch.int32, device=dev)
    if not with_dma:  # the never-written buffer holds geo[0]
        tile = _operands(geo[0], qp, K, round_ops).expand(blocks, -1, -1)
        window = geo[0, 0, :K].to(torch.float32).expand(blocks, -1)
    for i in range(visits):
        if with_dma:
            slots = geo[(bid * 7 + i * 13) % GEO_SLOTS]
            tile = _operands(slots, qp, K, round_ops)
            if i % 2 == 0:  # row 0 of the buffer lies in slot 0
                window = slots[:, 0, :K].to(torch.float32)
        dot = torch.zeros((blocks, 4 * K, BLOCK), dtype=torch.float32, device=dev)
        for f in range(F):
            dot.addcmul_(tile[:, f, :, None], feat[f])
        tt, ok = chain_plain(*dot.split(K, dim=1))
        leaf_min, kwin = tt.min(dim=1)
        if diag:
            count += ok.sum(dim=1, dtype=torch.int32)
            tmin = torch.minimum(tmin, torch.where(ok, tt, BIG).amin(dim=1))
        if with_fetch:
            improved = leaf_min < acc0
            fired = improved.any(dim=1, keepdim=True)
            acc1 = torch.where(fired, torch.where(improved, window.gather(1, kwin), 0.0), acc1)
            acc0 = torch.where(improved, leaf_min, acc0)
            taken += fired
        else:
            acc0 = torch.minimum(acc0, leaf_min)
    out = torch.zeros((8, blocks * BLOCK), dtype=torch.float32, device=dev)
    out[0] = acc0.reshape(-1)
    out[1] = acc1.reshape(-1)
    if not diag:
        return out
    return out, count.reshape(-1), tmin.reshape(-1), taken.expand(-1, BLOCK).reshape(-1)


def drain_cuda(geo, visits, quantities_packed, K_tri, precision, with_fetch, with_dma, blocks,
               diag=False):
    """K6 on the card: geo a CUDA tensor; returns what ``drain_plain`` does."""
    qp, K = quantities_packed, K_tri
    _check(geo, visits, qp, K, precision, blocks)
    if geo.device.type != "cuda":
        raise ValueError(f"drain_cuda takes a CUDA tensor, got {geo.device}")
    if not geo.is_contiguous():
        raise ValueError("geo must be contiguous")
    dev = geo.device
    bf16 = geo.dtype == torch.bfloat16
    round_ops = precision == "DEFAULT" or bf16
    feat = torch.ones((16 * qp, BLOCK), dtype=geo.dtype, device=dev)
    n = blocks * BLOCK
    out = torch.empty((8, n), dtype=torch.float32, device=dev)
    count = torch.empty(n, dtype=torch.int32, device=dev) if diag else None
    tmin = torch.empty(n, dtype=torch.float32, device=dev) if diag else None
    taken = torch.empty(n, dtype=torch.int32, device=dev) if diag else None
    with torch.cuda.device(dev):
        code = library().kz_drain_probe(
            geo.data_ptr(), feat.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if diag else None for t in (count, tmin, taken)),
            blocks, visits, qp, K, geo.shape[2], int(bf16), int(round_ops), int(with_fetch),
            int(with_dma), torch.cuda.current_stream(dev).cuda_stream)
    DRAIN_PROBE.launches += 1
    raise_on(code, DRAIN_PROBE)
    return (out, count, tmin, taken) if diag else out


def drain(geo, *args, **kwargs):
    """K6: the kernel for a CUDA geo, the plain version for a CPU one."""
    if geo.device.type == "cuda":
        return drain_cuda(geo, *args, **kwargs)
    if geo.device.type == "cpu":
        return drain_plain(geo, *args, **kwargs)
    raise ValueError(f"unsupported device {geo.device}")


def make_drain(visits, quantities_packed, K_tri, precision, with_fetch, with_dma, blocks,
               bf16=False, device="cuda"):
    """The original's interface: (run, geo), geo the original's ones on
    ``device``; ``run(geo, diag=False)``."""
    dev = resolve_device(device)
    wdt = torch.bfloat16 if bf16 else torch.float32
    geo = torch.ones(geo_shape(quantities_packed, K_tri), dtype=wdt, device=dev)
    _check(geo, visits, quantities_packed, K_tri, precision, blocks)

    def run(geo, diag=False):
        return drain(geo, visits, quantities_packed, K_tri, precision, with_fetch, with_dma,
                     blocks, diag=diag)

    return run, geo


def main(device="cuda", blocks: int = BLOCKS, visits: int = VISITS, calls: int = 10):
    """Run the original's 8 configurations on their geo of ones: ms per
    launch over ``calls`` launches after a warm-up (CUDA events on the card)
    and us per visit. Prints one line each and returns the rows."""
    dev = resolve_device(device)
    where = device_name(dev)
    rows = []
    for label, qp, kt, prec, bf16, fetch, dma in CONFIGS:
        run, geo = make_drain(visits, qp, kt, prec, fetch, dma, blocks, bf16=bf16, device=dev)
        ms = timed(lambda: run(geo), dev, calls)
        per_visit = ms * 1e-3 / (blocks * visits)
        rows.append({"label": label.strip(), "qp": qp, "K": kt, "precision": prec, "bf16": bf16,
                     "fetch": fetch, "dma": dma, "blocks": blocks, "visits": visits, "ms": ms,
                     "us_per_visit": per_visit * 1e6})
        print(f"{label}: {ms:8.2f} ms total, {per_visit * 1e6:6.3f} us/visit [{where}]",
              flush=True)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
