"""K4 and K5: the port of ``benchmarks/mxu_lab.py``.

K4 (``mm_probe``) is ``make_mm_kernel``'s kernel: ``out = sum over reps of
W^T f``, W (K, M) and f (K, N) contracted on dim 0, the reps summed in f32
one after another. K5 (``chain_probe``) is ``main``'s ``vpu_kernel``: 32
reps of the sign-folded Moller-Trumbore acceptance chain on the four
128-row slices of ``a`` (512, N), ``acc = min(acc, tt + r)`` from 0.

Precision is ``"HIGHEST"`` (f32 products) or ``"DEFAULT"``: the TPU's one
bf16 pass, both operands rounded to bf16 (round to nearest even) and their
products summed in f32. bf16 operands ("bf16-in") are taken as they are.

Both outputs of K5 are 0 on every input: each accepted ``tt`` is >= 0, so
``min(0, tt + r)`` stays 0. ``chain_probe(a, diag=True)`` also returns, per
element, the count of accepted tests and the least accepted ``tt`` (3e38
when none), which do depend on the input.

Each wrapper launches its kernel (``csrc/lab.cu``) for CUDA tensors and runs
its plain PyTorch version for CPU tensors. K4 runs on the CUDA cores at
every precision, in the plain version's order of sums, so the two agree
bit for bit: 512 reps of the sum turn any other order of P's sums (a
tensor core's) into more than the 1e-5 x max it is held to. ``main()`` runs the original's
table on the card: ``python -m kazen_tpu_torch.lab.mxu_lab [--device cpu]``
(on the CPU, ``main("cpu", n=64, reps=2)`` runs the plain versions small).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.device import resolve_device
from ..cuda_build import CudaKernel
from . import device_name, library, raise_on, timed

MM_PROBE = CudaKernel("mm_probe", "benchmarks/mxu_lab.py:52")
CHAIN_PROBE = CudaKernel("chain_probe", "benchmarks/mxu_lab.py:127")

PRECISIONS = ("HIGHEST", "DEFAULT")
TILE = 64  # M and N are multiples of it
MAX_K = 128
CHAIN_ROWS = 128  # rows of each of the four slices of K5's input
CHAIN_REPS = 32
BIG = 3.0e38
DET_EPS = 1e-8

# the original's table (benchmarks/mxu_lab.py:main)
N = 1024
REPS = 512
SHAPES = ((128, 16), (512, 16), (128, 64), (128, 128), (512, 64), (512, 128), (1024, 128))
BF16_SHAPES = ((128, 16), (512, 64), (512, 128), (1024, 128))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def _check_mm(w: torch.Tensor, f: torch.Tensor, reps: int, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if w.dtype not in (torch.float32, torch.bfloat16) or f.dtype != w.dtype:
        raise ValueError(f"w and f must both be float32 or both bfloat16, got {w.dtype}, {f.dtype}")
    if w.dim() != 2 or f.dim() != 2 or w.shape[0] != f.shape[0]:
        raise ValueError(f"w (K, M) and f (K, N) expected, got {tuple(w.shape)}, {tuple(f.shape)}")
    k, m = w.shape
    n = f.shape[1]
    if not 1 <= k <= MAX_K or m % TILE or n % TILE or m == 0 or n == 0:
        raise ValueError(f"K in 1..{MAX_K} and M, N positive multiples of {TILE}, "
                         f"got K={k} M={m} N={n}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if w.device != f.device:
        raise ValueError(f"w on {w.device}, f on {f.device}")


def mm_probe_plain(w: torch.Tensor, f: torch.Tensor, reps: int,
                   precision: str = "HIGHEST") -> torch.Tensor:
    """The plain version: P = W^T f in f32, summed over k = 0..K-1 in order
    (operands rounded to bf16 first for DEFAULT), then ``acc = acc + P``
    reps times."""
    _check_mm(w, f, reps, precision)
    a, b = w.to(torch.float32), f.to(torch.float32)
    if precision == "DEFAULT":
        a, b = round_bf16(a), round_bf16(b)
    p = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float32, device=a.device)
    for k in range(a.shape[0]):
        p.addcmul_(a[k, :, None], b[k, None, :])
    acc = torch.zeros_like(p)
    for _ in range(reps):
        acc = acc + p
    return acc


def mm_probe_cuda(w: torch.Tensor, f: torch.Tensor, reps: int,
                  precision: str = "HIGHEST") -> torch.Tensor:
    """K4 on the card: w (K, M), f (K, N) CUDA tensors -> (M, N) f32."""
    _check_mm(w, f, reps, precision)
    if w.device.type != "cuda":
        raise ValueError(f"mm_probe_cuda takes CUDA tensors, got {w.device}")
    if not (w.is_contiguous() and f.is_contiguous()):
        raise ValueError("w and f must be contiguous")
    (k, m), n = w.shape, f.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=w.device)
    mode = 2 if w.dtype == torch.bfloat16 else PRECISIONS.index(precision)
    with torch.cuda.device(w.device):
        code = library().kz_mm_probe(w.data_ptr(), f.data_ptr(), out.data_ptr(), m, k, n, reps,
                                     mode, torch.cuda.current_stream(w.device).cuda_stream)
    MM_PROBE.launches += 1
    raise_on(code, MM_PROBE)
    return out


def mm_probe(w: torch.Tensor, f: torch.Tensor, reps: int,
             precision: str = "HIGHEST") -> torch.Tensor:
    """sum over reps of W^T f: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if w.device.type == "cuda":
        return mm_probe_cuda(w, f, reps, precision)
    if w.device.type == "cpu":
        return mm_probe_plain(w, f, reps, precision)
    raise ValueError(f"unsupported device {w.device}")


def make_mm_kernel(M: int, K: int, N: int, precision: str, reps: int):
    """The original's interface: ``run(w, f)`` for w (K, M) and f (K, N)."""

    def run(w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        if tuple(w.shape) != (K, M) or tuple(f.shape) != (K, N):
            raise ValueError(f"run takes w {(K, M)} and f {(K, N)}, got "
                             f"{tuple(w.shape)}, {tuple(f.shape)}")
        return mm_probe(w, f, reps, precision)

    return run


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def chain_plain(det, tn, un, vn):
    """The sign-folded Moller-Trumbore acceptance: (tt, accepted), tt = 3e38
    where rejected. The plain reciprocal is exact; the kernel's is
    rcp.approx (the original's approx=True), so tt may differ in its last
    bits, the acceptance never."""
    s = torch.ones_like(det).masked_fill_(det < 0, -1.0)
    sd, su, sv, st = det * s, un * s, vn * s, tn * s
    q = torch.minimum(torch.minimum(su, sv),
                      torch.minimum(sd - su - sv, torch.minimum(st, sd - st)))
    ok = (sd > DET_EPS) & (q >= 0.0)
    return torch.where(ok, st * torch.reciprocal(sd), BIG), ok


def _check_chain(a: torch.Tensor) -> None:
    if a.dtype != torch.float32 or a.dim() != 2 or a.shape[0] != 4 * CHAIN_ROWS:
        raise ValueError(f"a must be ({4 * CHAIN_ROWS}, N) float32, got {tuple(a.shape)} {a.dtype}")
    if a.shape[1] == 0 or CHAIN_ROWS * a.shape[1] >= 2**31:
        raise ValueError(f"N must be in 1..{2**31 // CHAIN_ROWS - 1}, got {a.shape[1]}")


def chain_probe_plain(a: torch.Tensor, diag: bool = False):
    """The plain version of K5: out (128, N), or (out, count, tmin) with
    ``diag``."""
    _check_chain(a)
    acc = torch.zeros((CHAIN_ROWS, a.shape[1]), dtype=torch.float32, device=a.device)
    count = torch.zeros(acc.shape, dtype=torch.int32, device=a.device)
    tmin = torch.full(acc.shape, BIG, dtype=torch.float32, device=a.device)
    for r in range(CHAIN_REPS):
        tt, ok = chain_plain(*a.split(CHAIN_ROWS))
        acc = torch.minimum(acc, tt + float(r))
        if diag:
            count += ok
            tmin = torch.minimum(tmin, torch.where(ok, tt, BIG))
    return (acc, count, tmin) if diag else acc


def chain_probe_cuda(a: torch.Tensor, diag: bool = False):
    """K5 on the card: a (512, N) CUDA tensor -> out (128, N), or (out,
    count, tmin) with ``diag``."""
    _check_chain(a)
    if a.device.type != "cuda":
        raise ValueError(f"chain_probe_cuda takes a CUDA tensor, got {a.device}")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError("a must be contiguous and 16-byte aligned")
    n = a.shape[1]
    out = torch.empty((CHAIN_ROWS, n), dtype=torch.float32, device=a.device)
    count = torch.empty(out.shape, dtype=torch.int32, device=a.device) if diag else None
    tmin = torch.empty_like(out) if diag else None
    with torch.cuda.device(a.device):
        code = library().kz_chain_probe(
            a.data_ptr(), out.data_ptr(), count.data_ptr() if diag else None,
            tmin.data_ptr() if diag else None, n, CHAIN_REPS,
            torch.cuda.current_stream(a.device).cuda_stream)
    CHAIN_PROBE.launches += 1
    raise_on(code, CHAIN_PROBE)
    return (out, count, tmin) if diag else out


def chain_empty_cuda(a: torch.Tensor) -> None:
    """An empty kernel launched at K5's launch shape for ``a``: the card's
    floor for such a launch. Not a launch of K5."""
    _check_chain(a)
    if a.device.type != "cuda":
        raise ValueError(f"chain_empty_cuda takes a CUDA tensor, got {a.device}")
    with torch.cuda.device(a.device):
        code = library().kz_chain_empty(a.shape[1],
                                        torch.cuda.current_stream(a.device).cuda_stream)
    raise_on(code, CHAIN_PROBE)


def chain_probe(a: torch.Tensor, diag: bool = False):
    """K5: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if a.device.type == "cuda":
        return chain_probe_cuda(a, diag)
    if a.device.type == "cpu":
        return chain_probe_plain(a, diag)
    raise ValueError(f"unsupported device {a.device}")


# ---------------------------------------------------------------------------
# the original's table
# ---------------------------------------------------------------------------


def main(device="cuda", n: int = N, reps: int = REPS, calls: int = 20):
    """Run the original's table: each (precision, M, K) at N = ``n``, ``reps``
    products a launch, then the bf16-in shapes, then the chain on (512, n).
    Inputs are uniform in [0, 1) from numpy's generator seeded 0, drawn in
    the original's order. Prints one line each and returns (the product
    rows, the chain row): ms per launch over ``calls`` launches after a
    warm-up, timed with CUDA events on the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    where = device_name(dev)
    rows = []

    def record(kind, w, f, m, k):
        run = make_mm_kernel(m, k, n, "HIGHEST" if kind == "HIGHEST" else "DEFAULT", reps)
        ms = timed(lambda: run(w, f), dev, calls)
        per = ms * 1e-3 / reps
        rows.append({"kind": kind, "M": m, "K": k, "N": n, "reps": reps, "ms": ms,
                     "us_per_mm": per * 1e6, "tmacs": m * n * k / per / 1e12})
        print(f"{kind:8s} M={m:5d} K={k:4d} N={n}: {per * 1e6:8.3f} us/mm  "
              f"({rows[-1]['tmacs']:7.2f} Tmac/s) [{where}]", flush=True)

    for kind in ("DEFAULT", "HIGHEST"):
        for m, k in SHAPES:
            w = torch.from_numpy(rng.random((k, m), dtype=np.float32)).to(dev)
            f = torch.from_numpy(rng.random((k, n), dtype=np.float32)).to(dev)
            record(kind, w, f, m, k)
    for m, k in BF16_SHAPES:
        w = torch.from_numpy(rng.random((k, m), dtype=np.float32)).to(dev, torch.bfloat16)
        f = torch.from_numpy(rng.random((k, n), dtype=np.float32)).to(dev, torch.bfloat16)
        record("bf16-in", w, f, m, k)

    a = torch.from_numpy(rng.random((4 * CHAIN_ROWS, n), dtype=np.float32)).to(dev)
    ms = timed(lambda: chain_probe(a), dev, calls)
    chain = {"N": n, "reps": CHAIN_REPS, "ms": ms, "us_per_rep": ms * 1e3 / CHAIN_REPS}
    print(f"acceptance chain ({CHAIN_ROWS}x{n}, {CHAIN_REPS} reps): "
          f"{chain['us_per_rep']:8.3f} us/rep [{where}]", flush=True)
    return rows, chain


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
