"""kazen_tpu_torch/lab (the lab probes K4-K6) against the Pallas originals of
benchmarks/mxu_lab.py and benchmarks/visit_lab.py, run unmodified on the CPU
in TPU interpret mode, where the port runs each kernel's plain version.

Limits: K4 within max abs err 1e-5 * max|out| (the two sum the K products in
different orders); K5 and K6 outputs equal. Those outputs are 0 on every
input (each accepted tt is >= 0), so the per-lane diagnostics (accepted
tests, least accepted tt, fetches) are held to an independent numpy
transcription of the chain: counts exact, least tt within rtol 1e-6.

On the CPU, XLA ignores the precision of a dot, so DEFAULT (on the TPU one
bf16 pass: operands rounded to bf16, sums in f32) is fed to the original as
operands rounded to bf16 beforehand; the port rounds them itself.
"""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import mxu_lab as mxu_j
from benchmarks import visit_lab as visit_j
from kazen_tpu_torch.lab import mxu_lab as mxu_t
from kazen_tpu_torch.lab import visit_lab as visit_t

import torch_port_helpers  # noqa: F401  (the port's tests' torch-thread policy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PRECISION = {"HIGHEST": jax.lax.Precision.HIGHEST, "DEFAULT": jax.lax.Precision.DEFAULT}
BIG = np.float32(3e38)


def bf16_round(x: np.ndarray) -> np.ndarray:
    return x.astype(jnp.bfloat16).astype(np.float32)


def np_chain(det, tn, un, vn):
    """The acceptance chain in numpy f32, written from the original: (tt,
    accepted), tt = 3e38 where rejected."""
    s = np.where(det < 0, np.float32(-1), np.float32(1))
    sd, su, sv, st = det * s, un * s, vn * s, tn * s
    q = np.minimum(np.minimum(su, sv), np.minimum(sd - su - sv, np.minimum(st, sd - st)))
    ok = (sd > np.float32(1e-8)) & (q >= 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = np.where(ok, st * (np.float32(1) / sd), BIG)
    return tt.astype(np.float32), ok


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [8, 16, 40, 64])
@pytest.mark.parametrize("kind", ["HIGHEST", "DEFAULT", "bf16-in"])
def test_mm_probe_matches_pallas(kind, K):
    M, N, reps = 128, 256, 4
    rng = np.random.default_rng(K)
    w = rng.random((K, M), dtype=np.float32)
    f = rng.random((K, N), dtype=np.float32)
    if kind == "bf16-in":
        w_j, f_j = w.astype(jnp.bfloat16), f.astype(jnp.bfloat16)
        w_t = torch.from_numpy(bf16_round(w)).to(torch.bfloat16)
        f_t = torch.from_numpy(bf16_round(f)).to(torch.bfloat16)
    else:
        w_j, f_j = (bf16_round(w), bf16_round(f)) if kind == "DEFAULT" else (w, f)
        w_t, f_t = torch.from_numpy(w), torch.from_numpy(f)
    prec = "HIGHEST" if kind == "HIGHEST" else "DEFAULT"
    with pltpu.force_tpu_interpret_mode():
        run = mxu_j.make_mm_kernel(M, K, N, JAX_PRECISION[prec], reps)
        want = np.asarray(run(jnp.asarray(w_j), jnp.asarray(f_j)))
    got = mxu_t.make_mm_kernel(M, K, N, prec, reps)(w_t, f_t).numpy()
    assert got.shape == want.shape == (M, N) and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_mm_probe_limit_needs_the_plain_order():
    """Why K4 keeps the plain version's order of sums over k at every
    precision: P summed in another order (here k reversed) is within 4e-7 of
    the plain P, but 512 round-to-nearest sums of it land more than 1e-5 x
    max away from the plain version's, the limit the kernel is held to."""
    M, N, K, reps = 128, 256, 128, mxu_t.REPS
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.random((K, M), dtype=np.float32))
    f = torch.from_numpy(rng.random((K, N), dtype=np.float32))
    a, b = mxu_t.round_bf16(w), mxu_t.round_bf16(f)
    p = torch.zeros((M, N))
    for k in reversed(range(K)):
        p.addcmul_(a[k, :, None], b[k, None, :])
    acc = torch.zeros_like(p)
    for _ in range(reps):
        acc = acc + p
    want_p = mxu_t.mm_probe_plain(w, f, 1, "DEFAULT")
    want = mxu_t.mm_probe_plain(w, f, reps, "DEFAULT")
    assert (p - want_p).abs().max() <= 4e-7 * want_p.abs().max()
    assert (acc - want).abs().max() > 1e-5 * want.abs().max()


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def pallas_vpu_kernel(n):
    """The original's `vpu_kernel`, a closure of benchmarks/mxu_lab.py:main
    that reads N from main's scope, taken out of main's body with ast and
    run in a namespace that gives it N."""
    path = os.path.join(REPO, "benchmarks", "mxu_lab.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    main = next(d for d in tree.body if isinstance(d, ast.FunctionDef) and d.name == "main")
    kernel = next(d for d in main.body if isinstance(d, ast.FunctionDef) and d.name == "vpu_kernel")
    ns = {"jnp": jnp, "pl": pl, "N": n}
    exec(compile(ast.Module(body=[kernel], type_ignores=[]), path, "exec"), ns)
    return ns["vpu_kernel"]


def test_chain_probe_matches_pallas():
    n = 256
    a = np.random.default_rng(0).random((512, n), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            pallas_vpu_kernel(n), out_shape=jax.ShapeDtypeStruct((128, n), jnp.float32),
        )(jnp.asarray(a)))
    got = mxu_t.chain_probe(torch.from_numpy(a)).numpy()
    assert got.shape == (128, n)
    np.testing.assert_array_equal(got, want)
    assert not got.any()  # the probe's output is 0 on every input


@pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (-1.0, 1.0)])
def test_chain_probe_diagnostics(lo, hi):
    a = np.random.default_rng(1).uniform(lo, hi, (512, 192)).astype(np.float32)
    out, count, tmin = mxu_t.chain_probe(torch.from_numpy(a), diag=True)
    tt, ok = np_chain(*np.split(a, 4))
    assert ok.sum() > 100
    np.testing.assert_array_equal(count.numpy(), mxu_t.CHAIN_REPS * ok.astype(np.int32))
    np.testing.assert_allclose(tmin.numpy(), np.where(ok, tt, BIG), rtol=1e-6)
    assert not out.numpy().any()


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

BLOCKS, VISITS = 2, 3


def accepting_range(qp):
    """A geo range where tests are accepted. With qp = 4 the four quantities
    are independent sums of 64 values, and [-1, 1] accepts ~1-2% of tests;
    with qp = 1 they are D, D+16, D+32, D+48 (D the sum of 16 values), and
    a test is accepted only for D in [-80, -48], so values in [-5, -1]."""
    return (-1.0, 1.0) if qp == 4 else (-5.0, -1.0)


def seeded_geo(shape, bf16, lo, hi, seed=3):
    g = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return bf16_round(g) if bf16 else g


def np_drain_diag(geo32, visits, qp, K, round_ops, dma, blocks):
    """Per lane: accepted tests and least accepted tt, from the original's
    definition; feat is ones, so every lane of a block sees the same sums."""
    rnd = bf16_round if round_ops else (lambda x: x)
    F = 16 * qp
    count = np.zeros(blocks, np.int64)
    tmin = np.full(blocks, BIG, np.float32)
    for b in range(blocks):
        for i in range(visits):
            w = geo32[(7 * b + 13 * i) % 256] if dma else geo32[0]
            if qp == 1:
                ops = [rnd(w[:, :K] + np.float32(j)) if j else rnd(w[:, :K]) for j in range(4)]
            else:
                ops = [rnd(w[:, j * K:(j + 1) * K]) for j in range(4)]
            sums = []
            for op in ops:
                s = np.zeros(K, np.float32)
                for r in range(F):
                    s = s + op[r]
                sums.append(s)
            tt, ok = np_chain(*sums)
            count[b] += ok.sum()
            if ok.any():
                tmin[b] = min(tmin[b], tt[ok].min())
    return np.repeat(count, visit_t.BLOCK), np.repeat(tmin, visit_t.BLOCK)


CONFIG_IDS = [c[0].strip() for c in visit_t.CONFIGS]


@pytest.mark.parametrize("config", visit_t.CONFIGS, ids=CONFIG_IDS)
def test_drain_matches_pallas(config):
    """The original's make_drain, run unmodified in interpret mode, on its
    own geo of ones and on seeded geos: the port's rows equal its rows."""
    _, qp, kt, prec, bf16, fetch, dma = config
    with pltpu.force_tpu_interpret_mode():
        run_j, geo_j = visit_j.make_drain(VISITS, qp, kt, JAX_PRECISION[prec], fetch, dma, BLOCKS,
                                          bf16=bf16)
        geos = [np.asarray(geo_j).astype(np.float32)]
        geos += [seeded_geo(geo_j.shape, bf16, *r)
                 for r in dict.fromkeys([(-1.0, 1.0), accepting_range(qp)])]
        wants = [np.asarray(run_j(jnp.asarray(g).astype(geo_j.dtype))) for g in geos]
    run_t, geo_t = visit_t.make_drain(VISITS, qp, kt, prec, fetch, dma, BLOCKS, bf16=bf16,
                                      device="cpu")
    assert tuple(geo_t.shape) == geo_j.shape and (geo_t == 1).all()
    for g, want in zip(geos, wants):
        got = run_t(torch.from_numpy(g).to(geo_t.dtype))
        assert got.shape == (8, BLOCKS * visit_t.BLOCK)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("config", visit_t.CONFIGS, ids=CONFIG_IDS)
def test_drain_diagnostics(config):
    _, qp, kt, prec, bf16, fetch, dma = config
    run, geo = visit_t.make_drain(VISITS, qp, kt, prec, fetch, dma, BLOCKS, bf16=bf16,
                                  device="cpu")
    g = seeded_geo(tuple(geo.shape), bf16, *accepting_range(qp))
    out, count, tmin, taken = run(torch.from_numpy(g).to(geo.dtype), diag=True)
    want_count, want_tmin = np_drain_diag(g, VISITS, qp, kt, prec == "DEFAULT" or bf16, dma,
                                          BLOCKS)
    assert want_count.min() > 0
    np.testing.assert_array_equal(count.numpy(), want_count)
    np.testing.assert_allclose(tmin.numpy(), want_tmin, rtol=1e-6)
    assert not taken.numpy().any() and not out.numpy().any()


# ---------------------------------------------------------------------------
# wrappers and entry points
# ---------------------------------------------------------------------------

W, F_ = torch.ones(16, 128), torch.ones(16, 256)


@pytest.mark.parametrize("call, error", [
    (lambda: mxu_t.mm_probe(W.double(), F_.double(), 1), "float32"),
    (lambda: mxu_t.mm_probe(W, F_.to(torch.bfloat16), 1), "float32"),
    (lambda: mxu_t.mm_probe(W, torch.ones(8, 256), 1), "expected"),
    (lambda: mxu_t.mm_probe(torch.ones(16, 96), F_, 1), "multiples"),
    (lambda: mxu_t.mm_probe(torch.ones(129, 128), torch.ones(129, 256), 1), "K in"),
    (lambda: mxu_t.mm_probe(W, F_, 0), "reps"),
    (lambda: mxu_t.mm_probe(W, F_, 1, "HIGH"), "precision"),
    (lambda: mxu_t.mm_probe_cuda(W, F_, 1), "CUDA"),
    (lambda: mxu_t.chain_probe(torch.ones(256, 64)), r"\(512, N\)"),
    (lambda: mxu_t.chain_probe(torch.ones(512, 64, dtype=torch.float64)), "float32"),
    (lambda: mxu_t.chain_probe_cuda(torch.ones(512, 64)), "CUDA"),
    (lambda: visit_t.drain(torch.ones(256, 16, 64), 1, 1, 128, "HIGHEST", True, True, 1), "geo"),
    (lambda: visit_t.drain(torch.ones(256, 16, 128, dtype=torch.float16), 1, 1, 128,
                           "HIGHEST", True, True, 1), "bfloat16"),
    (lambda: visit_t.drain(torch.ones(256, 16, 128), 1, 2, 128, "HIGHEST", True, True, 1),
     "quantities_packed"),
    (lambda: visit_t.drain_cuda(torch.ones(256, 16, 128), 1, 1, 128, "HIGHEST", True, True, 1),
     "CUDA"),
    (lambda: visit_t.make_drain(1, 4, 256, "HIGHEST", True, True, 1, device="cpu"),
     "shared memory"),
])
def test_wrappers_raise(call, error):
    with pytest.raises(ValueError, match=error):
        call()


def test_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (mxu_t.main, visit_t.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()
    with pytest.raises(RuntimeError, match="CUDA"):
        visit_t.make_drain(1, 1, 128, "HIGHEST", True, True, 1)


def test_mxu_main_on_cpu(capsys):
    rows, chain = mxu_t.main(device="cpu", n=64, reps=2, calls=1)
    kinds = [(r["kind"], r["M"], r["K"]) for r in rows]
    assert kinds == ([("DEFAULT", m, k) for m, k in mxu_t.SHAPES]
                     + [("HIGHEST", m, k) for m, k in mxu_t.SHAPES]
                     + [("bf16-in", m, k) for m, k in mxu_t.BF16_SHAPES])
    assert all(r["ms"] > 0 for r in rows) and chain["ms"] > 0
    assert capsys.readouterr().out.count("[cpu]") == len(rows) + 1


def test_visit_main_on_cpu(capsys):
    rows = visit_t.main(device="cpu", blocks=1, visits=1, calls=1)
    assert [r["label"] for r in rows] == CONFIG_IDS
    assert all(r["ms"] > 0 for r in rows)
    assert capsys.readouterr().out.count("[cpu]") == len(rows)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Phase 17's kernel-against-plain checks of chip_smoke.py at small
    sizes: K4 at each precision and at K = 8, 40 and 64 (the f32 loop, bit
    for bit); K5 on three inputs, and its floor's empty kernel; K6 at each configuration (DEFAULT and bf16 on the tensor
    cores) with its diagnostics, on seeded geo, on integer geo (every sum
    exact) and at K = 100 and 36, not multiples of its 64-test chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lab kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for kind in ("HIGHEST", "DEFAULT", "bf16-in"):
        for K in (8, 40, 64):
            dt = torch.bfloat16 if kind == "bf16-in" else torch.float32
            w = torch.from_numpy(rng.random((K, 128), dtype=np.float32)).to(dev, dt)
            f = torch.from_numpy(rng.random((K, 256), dtype=np.float32)).to(dev, dt)
            prec = "HIGHEST" if kind == "HIGHEST" else "DEFAULT"
            before = mxu_t.MM_PROBE.launches
            got = mxu_t.mm_probe_cuda(w, f, 8, prec)
            want = mxu_t.mm_probe_plain(w, f, 8, prec)
            torch.cuda.synchronize()
            assert mxu_t.MM_PROBE.launches == before + 1
            assert torch.equal(got, want)
    # K5 on the original's input, the diagnostics' and one of signed zeros
    # and halves (tests of det = +-0 are rejected by both signs' rule)
    zeros = np.array([0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 0.25], np.float32)
    for x in (rng.random((512, 256), dtype=np.float32),
              rng.uniform(-1.0, 1.0, (512, 1000)).astype(np.float32),
              rng.choice(zeros, (512, 64))):
        a = torch.from_numpy(x).to(dev)
        got, want = mxu_t.chain_probe_cuda(a, diag=True), mxu_t.chain_probe_plain(a, diag=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    before = mxu_t.CHAIN_PROBE.launches
    mxu_t.chain_empty_cuda(a)
    torch.cuda.synchronize()
    assert mxu_t.CHAIN_PROBE.launches == before  # the floor's launch is not K5's
    padded = [("", 1, 100, "DEFAULT", False, True, True), ("", 4, 36, "DEFAULT", True, True, True)]
    for _, qp, kt, prec, bf16, fetch, dma in list(visit_t.CONFIGS) + padded:
        args = (VISITS, qp, kt, prec, fetch, dma, BLOCKS)
        shape = visit_t.geo_shape(qp, kt)
        integers = np.random.default_rng(5).integers(-8, 9, shape).astype(np.float32)
        for g in (seeded_geo(shape, bf16, *accepting_range(qp)), integers):
            geo = torch.from_numpy(g).to(dev, torch.bfloat16 if bf16 else torch.float32)
            got = visit_t.drain_cuda(geo, *args, diag=True)
            want = visit_t.drain_plain(geo, *args, diag=True)
            for x, y in zip(got, want):
                if x.dtype == torch.float32 and x.dim() == 1:
                    torch.testing.assert_close(x, y, rtol=1e-6, atol=0)
                else:
                    assert torch.equal(x, y)

