"""Each per-layer metric's arithmetic on a small recorded window, the
reduction of raw profiler events to stages, and the trace kernels' bound."""
import pytest
import torch

from kzbench import profile, registry, roofline
from kzbench.profile import Activity, Records

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    """A raw profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, dur, dev=CPU, corr=0):
        self._v = (name, start, dur, dev, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def window_events():
    """A 1000 ns window: a sampler span [100, 300] holding a permute-less
    draw, a shading span [300, 800] with a nested trace span [500, 600],
    and launches at 150, 350, 550, 900 whose kernels run 200-260, 400-500,
    600-650 (K1) and 950-990."""
    ev = [Ev(profile.WINDOW, 0, 1000),
          Ev(profile.SPAN + "sampler draws", 100, 200),
          Ev(profile.SPAN + "shading", 300, 500),
          Ev(profile.SPAN + "trace kernels", 500, 100)]
    for k, (ts, ks, kd, name) in enumerate([(150, 200, 60, "rng_kernel"),
                                            (350, 400, 100, "bsdf_kernel"),
                                            (550, 600, 50, "nearest_kernel<true>"),
                                            (900, 950, 40, "splat_kernel")]):
        ev.append(Ev("cudaLaunchKernel", ts, 5, CPU, k + 1))
        ev.append(Ev(name, ks, kd, CUDA, k + 1))
    return ev


def test_events_reduce_to_stages_busy_and_window():
    rec = profile.reduce_events(window_events(), units=2, host_window_s=1.0)
    assert [a.stage for a in rec.activities] == ["sampler draws", "shading", "trace kernels",
                                                 "other"]
    assert rec.busy_s == pytest.approx(250e-9)
    assert rec.window_s == pytest.approx(1000e-9)
    bd = profile.breakdown(rec)
    assert bd["device_ops"][0] == ["shading: bsdf_kernel", pytest.approx(100e-9)]
    assert bd["idle_gaps"][0] == ["other -> splat_kernel", pytest.approx(300e-9)]
    assert len(bd["idle_gaps"]) == 3


def metric(name):
    return registry.metric(name)


def test_kernel_base_names():
    assert profile.kernel_base(
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl<F>(...)>(int, F)"
    ) == "elementwise_kernel"
    assert profile.kernel_base("nearest_kernel<true>") == "nearest_kernel"
    assert profile.kernel_base("Memset (Device)") == "Memset"
    assert profile.kernel_base(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(...)"
    ) == "CatArrayBatchedCopy"


def test_each_metric_on_a_recorded_window():
    rec = profile.reduce_events(window_events(), units=2, host_window_s=1.0)
    rec.launches = {"K1": [{"bound_s": 20e-9}], "K2": []}
    rec.extra["trace_kernel_names"] = {"K1": "nearest_kernel", "K2": "any_hit_kernel"}
    assert metric("launches_per_pass").read(rec) == 2.0
    assert metric("sampler_launches_per_pass").read(rec) == 0.5
    assert metric("shade_device_ms_per_pass").read(rec) == pytest.approx(100e-6 / 2)
    assert metric("trace_roofline").read(rec) == pytest.approx(100.0 * 20 / 50)
    assert metric("device_idle_share.render").read(rec) == pytest.approx(75.0)


def test_a_metric_with_nothing_to_read_returns_none():
    empty = Records(units=0, window_s=0.0, busy_s=0.0, activities=[])
    for name in registry.metric_names():
        assert metric(name).read(empty) is None, name
    # launches but no trace kernel: no roofline share, never 0
    rec = Records(units=1, window_s=1.0, busy_s=0.5,
                  activities=[Activity("k", 0, 10, "shading")])
    rec.extra["trace_kernel_names"] = {"K1": "nearest_kernel"}
    assert metric("trace_roofline").read(rec) is None
    assert metric("sampler_launches_per_pass").read(rec) is None


def test_trace_kernel_bound_arithmetic():
    """The phase-4 arithmetic: (8 + 34) rows of 4 bytes a ray for K1, (8 + 1)
    for K2, plus the tables; 45 flops a triangle test; 3.35 TB/s and 67
    TFLOP/s."""
    n = 1920 * 1080
    s, by = roofline.launch_bound_s("K1", n, 0.0, 0)
    assert by == "bytes" and s == pytest.approx(42 * 4 * n / 3.35e12)
    # the stand-in pass's first K1 launch: 0.1040 ms of rays and rows
    assert s * 1e3 == pytest.approx(0.10399, abs=1e-5)
    s, by = roofline.launch_bound_s("K2", n, 4.437e7, 10 ** 6)
    assert by == "operations" and s == pytest.approx(4.437e7 * 45 / 67e12)
    # phase 4's K2 bound on the stand-in: 0.0298 ms by operations
    assert s * 1e3 == pytest.approx(0.0298, abs=1e-4)
    assert roofline.MT_FLOPS == 45
