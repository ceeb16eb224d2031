"""The sampler's draw kernel (samplers/draw_kernel.py, samplers/csrc/draws.cu)
and the route of samplers/streams.py's four draws: CPU lanes take the plain
version and the tracer counts each draw by route; the wrapper checks its
lanes and tables before any launch (a stub library stands in for the
card's); the kernel's source, compiled for the host with g++, equals the
plain version under the card's division rule; and (marked cuda) the kernel
equals the plain version on the card. No JAX is needed here (only the
thread policy's helpers import it): the card's machine runs this file."""
import contextlib
import ctypes
import json
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kazen_tpu_torch.core import rng
from kazen_tpu_torch.examples import baseline_configs as bc
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.samplers import draw_kernel as dk
from kazen_tpu_torch.samplers import streams, tables
from kazen_tpu_torch.scene.compiler import compile_scene
from kazen_tpu_torch.utils import metrics

try:  # the port's tests' torch-thread policy; the card's machine has no JAX
    import torch_port_helpers  # noqa: F401
except ModuleNotFoundError as e:
    if e.name != "jax":
        raise

FIELDS = streams.StreamState._fields
SPPS = (1, 4, 16, 64, 128)  # stratified 128 -> 144 strata, correlated 128 -> 12 x 11: cycle-walks
STEPS = 52  # draws after the init: past dimension 60 on every kind
HELD_DRAWS = 1 + STEPS  # the draw calls held() makes by their route
ROUTED = {"pixel": streams.next_pixel_2d, "1d": streams.next_1d, "2d": streams.next_2d}


def spec_for(kind, spp, device):
    if kind == "pmj02bn":
        return tables.make_pmj02bn_spec(spp, seed=3, device=device)
    return streams.SamplerSpec(kind=kind, sample_count=spp, seed=3)


def pixels(device):
    """Pixels beyond the blue-noise period (128) and the pixel tiles, the
    lane-chunked pass's off-image padding column (x = 0x7FFFFF), then a
    64x36 frame: lanes over several blocks."""
    r = np.random.RandomState(5)
    ys, xs = np.mgrid[0:36, 0:64]
    px = np.concatenate([r.randint(0, 300, 200), [0x7FFFFF, 127, 128], xs.ravel()])
    py = np.concatenate([r.randint(0, 300, 200), [0, 127, 128], ys.ravel()])
    return (torch.as_tensor(px.astype(np.int64), device=device),
            torch.as_tensor(py.astype(np.int64), device=device))


def sample_and_jump(spec, n, per_lane, device):
    """A sample index and its jump: one for all lanes (ints), or one a lane
    (int64 lane tensors, A a strided column as dist/sharding.py gives it)."""
    count = spec.effective_sample_count
    if not per_lane:
        s = 5 % count
        return s, rng.advance_constants(s * 65536)
    rows = [[rng.s64(v) for v in rng.advance_constants(k * 65536)] for k in range(count)]
    table = torch.tensor(rows, dtype=torch.int64, device=device)
    si = torch.arange(n, device=device) % count
    lanes = table[si]
    return si, (lanes[:, 0], lanes[:, 1].contiguous())


def permuted(st):
    """The stream as the ordered permute hands it on: strided columns of
    one (N, 7) tensor."""
    lane = torch.arange(st.px.shape[0], device=st.px.device)
    return streams.StreamState(*torch.stack([*st, lane], dim=1)[:, :6].unbind(1))


def plain(spec, draw, st):
    if draw == "pixel" and spec.kind == "pmj02bn":
        return streams._pixel_2d_plain(spec, st)
    return (streams._next_1d_plain if draw == "1d" else streams._next_2d_plain)(spec, st)


def same(a, b) -> bool:
    def bits(t):
        return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def held(spec, px, py, si, jump):
    """The init and STEPS draws (pixel, 2d, 1d, 2d, ...) each by its route,
    traced, and by the plain version on the same stream. Returns (the
    (draw, field) pairs that differ, what the tracer collected of the
    routed draws)."""
    differ = []
    metrics.collect()
    with metrics.tracing():
        st = streams.init_stream_jump(spec, px, py, si, jump)
    want = streams._init_plain(spec, px, py, si, jump)
    differ += [("init", f) for f in FIELDS if not same(getattr(st, f), getattr(want, f))]
    st = permuted(st)
    for step in range(STEPS):
        draw = ("pixel", "2d", "1d", "2d")[step % 4]
        with metrics.tracing():
            got = ROUTED[draw](spec, st)
        want = plain(spec, draw, st)
        differ += [(f"{step} {draw}", f) for f in FIELDS
                   if not same(getattr(got[0], f), getattr(want[0], f))]
        if not same(got[1], want[1]):
            differ.append((f"{step} {draw}", "u"))
        st = permuted(got[0]) if step % 3 == 0 else got[0]
    return differ, metrics.collect()


# ---------------------------------------------------------------------------
# the route on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", streams.KINDS)
def test_cpu_lanes_take_the_plain_route(kind):
    """CPU lanes: every draw is the plain version's, bit for bit, counted
    "plain" by the tracer, with no kernel launch."""
    spec = spec_for(kind, 16, "cpu")
    px, py = pixels("cpu")
    si, jump = sample_and_jump(spec, px.shape[0], False, "cpu")
    before = dk.DRAWS.launches
    differ, got = held(spec, px, py, si, jump)
    assert differ == []
    assert got["sampler_route"] == {"plain": HELD_DRAWS}
    assert dk.DRAWS.launches == before and got["launches"] == {}


def test_sampler_route_counts_each_draw_of_a_con2_pass(tmp_path):
    """The sampler_route counter over a 1-pass con-2 render at 32x18 on the
    CPU: 35 draws (the init, the pixel jitter, the aperture, 5 bounces of 6
    and 2 Russian roulettes), all plain; with the tracer off nothing is
    counted; the Chrome trace carries it."""
    arrays, static = compile_scene(bc.at_size(bc.config_scene(4, spp=1), 32, 18), device="cpu")
    metrics.collect()
    render_t.render(arrays, static, device="cpu")
    assert metrics.collect()["sampler_route"] == {}
    metrics.collect()
    with metrics.tracing():
        render_t.render(arrays, static, device="cpu")
    got = metrics.collect()
    assert got["sampler_route"] == {"plain": 35}
    path = tmp_path / "trace.json"
    metrics.write_chrome_trace(str(path), got)
    assert json.loads(path.read_text())["otherData"]["sampler_route"] == {"plain": 35}


# ---------------------------------------------------------------------------
# the wrapper, with a stub library
# ---------------------------------------------------------------------------


class StubLibrary:
    """Stands in for the kernel's library: records each launch's
    parameters and returns ``code``."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def kz_sampler_draw(self, prm_ref, stream):
        prm = prm_ref._obj
        self.calls.append({name: getattr(prm, name) for name, _ in dk._Params._fields_})
        return self.code

    def kz_error_string(self, code):
        return b"stub failure"


@pytest.fixture
def stub(monkeypatch):
    lib = StubLibrary()
    monkeypatch.setattr(dk, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return lib


@pytest.fixture(scope="module")
def pmj_spec():
    return spec_for("pmj02bn", 16, "cpu")


def _stream(spec):
    px, py = pixels("cpu")
    return permuted(streams._init_plain(spec, px, py, 5, rng.advance_constants(5 * 65536)))


@pytest.mark.parametrize("draw", ["init", "init per lane", "1d", "2d", "pixel"])
def test_wrapper_passes_the_lanes_as_they_are(draw, stub, pmj_spec):
    """One launch a draw, with each lane field's pointer and stride as given
    (the permute's strided columns: stride 7), the static values as
    arguments, and outputs allocated for what the draw writes."""
    kind = "pmj02bn" if draw == "pixel" else "stratified"
    spec = pmj_spec if kind == "pmj02bn" else spec_for(kind, 128, "cpu")
    st = _stream(spec)
    n = st.px.shape[0]
    before = dk.DRAWS.launches
    if draw.startswith("init"):
        si, jump = sample_and_jump(spec, n, draw == "init per lane", "cpu")
        out = dk.init(spec, st.px, st.py, si, jump)
        assert [t.shape for t in out] == [(n,)] * 4
        if draw == "init":
            assert out[3] is not si
        else:
            assert out[3] is si
    elif draw == "pixel":
        out = dk.pixel_2d(spec, st)
        assert out.shape == (n, 2) and out.dtype == torch.float32
    else:
        out = dk.draw(spec, st, 1 if draw == "1d" else 2)
        assert out[2].shape == ((n,) if draw == "1d" else (n, 2))
    assert dk.DRAWS.launches == before + 1 and len(stub.calls) == 1
    prm = stub.calls[0]
    assert prm["op"] == {"init": dk.INIT, "init per lane": dk.INIT, "1d": dk.NEXT_1D,
                         "2d": dk.NEXT_2D, "pixel": dk.PIXEL_2D}[draw]
    assert (prm["lanes"], prm["kind"], prm["n"], prm["seed"]) == (
        n, dk.KIND_IDS[kind], spec.effective_sample_count, 3)
    if draw.startswith("init"):
        assert prm["px"] == st.px.data_ptr() and prm["px_s"] == 7
        if draw == "init":
            assert prm["jump_a"] is None and prm["sample_index"] is None
            assert (prm["ja0"], prm["js0"], prm["si0"]) == (*sample_and_jump(spec, n, False,
                                                                             "cpu")[1], 5)
        else:
            assert prm["jump_a"] == jump[0].data_ptr() and prm["jump_a_s"] == 2
            assert prm["si_out"] is None
    elif draw == "pixel":
        tile, size = spec.pmj_pixel_table
        assert (prm["tile"], prm["tile_size"], prm["tile_entries"]) == (
            tile.data_ptr(), size, tile.shape[0])
        assert prm["state_out"] is None and prm["dim_out"] is None
    else:
        for name in ("state", "inc", "dim", "px", "py", "sample_index"):
            assert prm[name] == getattr(st, name).data_ptr() and prm[f"{name}_s"] == 7, name
        assert (prm["res_x"], prm["res_y"]) == spec.resolution == (12, 12)
        assert prm["state_out"] == out[0].data_ptr() and prm["dim_out"] == out[1].data_ptr()


def _rejected(case, spec, st):
    """(wrapper, its arguments) of a call the kernel cannot take."""
    if case == "int32 field":
        return dk.draw, (spec, st._replace(dim=st.dim.to(torch.int32)), 1)
    if case == "float field":
        return dk.draw, (spec, st._replace(px=st.px.double()), 2)
    if case == "field of another length":
        return dk.draw, (spec, st._replace(py=st.py[:-1]), 1)
    if case == "2-D field":
        return dk.pixel_2d, (spec, st._replace(sample_index=st.sample_index[:, None]))
    if case == "non-contiguous table":
        bn = spec.bluenoise.transpose(1, 2)
        assert not bn.is_contiguous()
        return dk.draw, (_with(spec, bluenoise=bn), st, 1)
    if case == "float64 table":
        return dk.draw, (_with(spec, pmj_tables=spec.pmj_tables.double()), st, 2)
    lanes = torch.zeros(st.px.shape[0], dtype=torch.int64)  # a jump of an int and a tensor
    return dk.init, (spec_for("stratified", 4, "cpu"), st.px, st.py, 0, (1, lanes))


@pytest.mark.parametrize("case", [
    "int32 field", "float field", "field of another length", "2-D field",
    "non-contiguous table", "float64 table", "jump of an int and a tensor",
])
def test_wrapper_rejects_before_any_launch(case, stub, pmj_spec):
    """What the kernel cannot read raises ValueError, and nothing launches."""
    fn, args = _rejected(case, pmj_spec, _stream(pmj_spec))
    before = dk.DRAWS.launches
    with pytest.raises(ValueError):
        fn(*args)
    assert stub.calls == [] and dk.DRAWS.launches == before


def _with(spec, **tables_):
    return streams.SamplerSpec(kind=spec.kind, sample_count=spec.sample_count, seed=spec.seed,
                               **{"pmj_tables": spec.pmj_tables, "bluenoise": spec.bluenoise,
                                  "pmj_pixel_table": spec.pmj_pixel_table, **tables_})


def test_wrapper_raises_when_the_launch_fails(stub, pmj_spec):
    stub.code = 1
    with pytest.raises(RuntimeError, match="sampler_draw launch failed: stub failure"):
        dk.draw(pmj_spec, _stream(pmj_spec), 1)


def test_no_lanes_no_launch(stub, pmj_spec):
    st = streams.StreamState(*(f[:0] for f in _stream(pmj_spec)))
    before = dk.DRAWS.launches
    _, dim, u = dk.draw(pmj_spec, st, 2)
    assert dim.shape == (0,) and u.shape == (0, 2)
    assert stub.calls == [] and dk.DRAWS.launches == before


# ---------------------------------------------------------------------------
# the kernel's source on the host
# ---------------------------------------------------------------------------

LAUNCHES_BANNER = "// " + "-" * 75 + "\n// the launches (nvcc only)"
# the CUDA names draws.cu uses, for one host thread
HOST_SHIM = r"""
#include <cmath>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fdiv_rn(float a, float b) { return a / b; }
template <class T> inline T __ldg(const T* p) { return *p; }
using std::isnan;
static struct { unsigned x; } blockIdx, threadIdx;
"""

# the library's entry point: the kernel body once a lane, in order
HOST_DRIVER = r"""
#include "draws_body.cu"
namespace {
template <int OP, int KIND> void run(const Params& p) {
  for (long long i = 0; i < p.lanes; ++i) {
    blockIdx.x = (unsigned)(i / THREADS);
    threadIdx.x = (unsigned)(i % THREADS);
    draw_kernel<OP, KIND>(p);
  }
}
template <int OP> int run_kind(const Params& p) {
  switch (p.kind) {
    case INDEPENDENT: run<OP, INDEPENDENT>(p); return 0;
    case STRATIFIED: run<OP, STRATIFIED>(p); return 0;
    case CORRELATED: run<OP, CORRELATED>(p); return 0;
    case PMJ02BN: run<OP, PMJ02BN>(p); return 0;
  }
  return 1;
}
}  // namespace
extern "C" int kz_sampler_draw(const Params* p, void*) {
  switch (p->op) {
    case INIT: return run_kind<INIT>(*p);
    case NEXT_1D: return run_kind<NEXT_1D>(*p);
    case NEXT_2D: return run_kind<NEXT_2D>(*p);
    case PIXEL_2D: if (p->kind != PMJ02BN) return 1; run<PIXEL_2D, PMJ02BN>(*p); return 0;
  }
  return 1;
}
extern "C" const char* kz_error_string(int) { return "host failure"; }
"""


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """draws.cu above its launches' banner, built for the host with g++ (no
    contraction of products and sums, as -fmad=false on the card)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    with open(dk.SOURCE) as f:
        source = f.read()
    d = tmp_path_factory.mktemp("draws_host")
    (d / "shim.h").write_text(HOST_SHIM)
    (d / "draws_body.cu").write_text(source[:source.index(LAUNCHES_BANNER)])
    (d / "driver.cpp").write_text(HOST_DRIVER)
    lib = d / "libdraws_host.so"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-include",
         str(d / "shim.h"), "-o", str(lib), str(d / "driver.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    cdll = ctypes.CDLL(str(lib))
    cdll.kz_sampler_draw.argtypes = [ctypes.POINTER(dk._Params), ctypes.c_void_p]
    cdll.kz_sampler_draw.restype = ctypes.c_int
    cdll.kz_error_string.argtypes = [ctypes.c_int]
    cdll.kz_error_string.restype = ctypes.c_char_p
    return cdll


def _card_division(a, b, _div=torch.Tensor.__truediv__):
    """A float tensor divided by a Python number as PyTorch divides on the
    card: times the number's f32 reciprocal."""
    if isinstance(b, (int, float)) and not isinstance(b, bool) and a.dtype == torch.float32:
        return a * float(np.float32(1.0) / np.float32(b))
    return _div(a, b)


@pytest.mark.parametrize("kind", streams.KINDS)
def test_kernel_source_matches_plain_on_the_host(kind, host_library, monkeypatch):
    """The kernel's body, built for the host and run through the wrapper and
    streams.py's kernel route on CPU lanes, against the plain version with
    the card's division rule: every field and uniform bit for bit over
    every sample count, both jump forms and 60 dimensions."""
    monkeypatch.setattr(dk, "_library", lambda: host_library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))

    def kernel_route(lanes):
        metrics.sampler_route("kernel")
        return True

    monkeypatch.setattr(streams, "_kernel_route", kernel_route)
    monkeypatch.setattr(torch.Tensor, "__truediv__", _card_division)
    px, py = pixels("cpu")
    for spp in SPPS:
        spec = spec_for(kind, spp, "cpu")
        for per_lane in (False, True):
            si, jump = sample_and_jump(spec, px.shape[0], per_lane, "cpu")
            before = dk.DRAWS.launches
            differ, got = held(spec, px, py, si, jump)
            assert differ == [], (spp, per_lane, differ[:5])
            assert got["sampler_route"] == {"kernel": HELD_DRAWS}
            assert dk.DRAWS.launches - before == HELD_DRAWS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("spp", SPPS)
@pytest.mark.parametrize("kind", streams.KINDS)
def test_kernel_matches_plain_on_card(kind, spp):
    """The kernel against the plain version on the card: every field and
    uniform bit for bit over 60 dimensions, both jump forms, the padding
    lanes; one launch a draw, each counted "kernel", and no host read of
    core/rng.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the draw kernel has no CPU mode")
    spec = spec_for(kind, spp, "cuda")
    px, py = pixels("cuda")
    for per_lane in (False, True):
        si, jump = sample_and_jump(spec, px.shape[0], per_lane, "cuda")
        before = dk.DRAWS.launches
        differ, got = held(spec, px, py, si, jump)
        assert differ == [], (per_lane, differ[:5])
        assert got["sampler_route"] == {"kernel": HELD_DRAWS}
        assert dk.DRAWS.launches - before == HELD_DRAWS
        assert got["launches"] == {dk.DRAWS.name: HELD_DRAWS}
        assert not any(k.startswith("core/rng.py") for k in got["host_reads"])
