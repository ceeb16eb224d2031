"""The program's tracer (kazen_tpu_torch/utils/metrics.py) on the CPU: off,
it records nothing and touches no clock or profiler range; on, spans nest,
share their call's id and sit on torch.profiler's clock, the images stay bit
for bit, and the host-read counter equals the reads it wraps. Then the
arithmetic of lab/pass_split.py, which reads what the tracer collects."""
import gc
import json
import statistics
import sys

import pytest
import torch

from kazen_tpu_torch.diff import inverse
from kazen_tpu_torch.examples import baseline_configs as bc
from kazen_tpu_torch.integrate import render as render_t
from kazen_tpu_torch.lab import pass_split
from kazen_tpu_torch.scene.compiler import compile_scene
from kazen_tpu_torch.utils import metrics

from torch_port_helpers import multi_cluster_scene, textured_scene, to_port

SIZE = 16  # a 16x16 Cornell box with a kiss sphere, several clusters


@pytest.fixture(scope="module")
def scenes():
    """{sampler: (arrays, static)} of the box at 2 spp."""
    return {kind: compile_scene(to_port(multi_cluster_scene(SIZE, SIZE, sampler=kind, spp=2)),
                                device="cpu")
            for kind in ("independent", "pmj02bn")}


def traced(fn):
    """(fn(), what the tracer collected) with the tracer on for the call."""
    metrics.collect()
    with metrics.tracing():
        out = fn()
    return out, metrics.collect()


def run(what, scenes):
    arrays, static = scenes["pmj02bn" if what == "render" else "independent"]
    if what == "render":
        return render_t.render(arrays, static, device="cpu")
    target = torch.full((static.height, static.width, 3), 0.25)
    return inverse.optimize(arrays, static, target, steps=2, spp_per_step=1)


class Untouchable:
    """Stands in for what the tracer may not use while it is off."""

    def __init__(self, what):
        self.what = what

    def __getattr__(self, name):
        raise AssertionError(f"the tracer is off, yet {self.what}.{name} was used")

    def __call__(self, *args, **kwargs):
        raise AssertionError(f"the tracer is off, yet {self.what} was called")


@pytest.mark.parametrize("what", ["render", "optimize"])
def test_tracer_off_records_and_touches_nothing(what, scenes, monkeypatch):
    metrics.collect()
    monkeypatch.setattr(metrics, "time", Untouchable("time"))
    monkeypatch.setattr(metrics, "record_function", Untouchable("record_function"))
    monkeypatch.setattr(metrics, "Span", Untouchable("Span"))
    run(what, scenes)
    monkeypatch.undo()
    assert metrics.collect() == {"spans": [], "host_reads": {}, "texture_lookups": {},
                                 "shade_route": {}, "shade_plain_reason": {},
                                 "sampler_route": {}, "texture_footprint": {},
                                 "env_nee": {}, "beckmann_lobes": {},
                                 "launches": {}, "rays": 0.0}


NESTING = {
    # span: (parent, count) of a render() call of 2 passes at depth 5
    "render": {"render.call": (None, 1), "sampler.tables": ("render.call", 1),
               "render.pass": ("render.call", 2), "camera": ("render.pass", 2),
               "splat": ("render.pass", 2), "trace.nearest": ("render.pass", 2 * 2),
               "shading": ("render.pass", 2 * 6)},  # 5 bounces and the last prologue
    # span: (parent, count) of optimize(), 2 steps of one pass
    "optimize": {"optimize.step": (None, 2), "forward": ("optimize.step", 2),
                 "backward": ("optimize.step", 2), "optimizer": ("optimize.step", 2),
                 "render.pass": ("forward", 2)},
}


@pytest.mark.parametrize("what", ["render", "optimize"])
def test_spans_nest_and_share_their_calls_id(what, scenes):
    _, got = traced(lambda: run(what, scenes))
    spans = got["spans"]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.call == s.id
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s.name, p.name)
        assert s.call == (s.id if s.name in metrics.CALLS else p.call), s.name
    for name, (parent, count) in NESTING[what].items():
        mine = [s for s in spans if s.name == name]
        if parent is None:
            assert len(mine) == count and all(s.parent is None for s in mine), name
        else:
            assert len([s for s in mine if by_id[s.parent].name == parent]) == count, name
    roots = [s for s in spans if s.parent is None]
    assert {s.call for s in spans} == {s.id for s in roots}
    if what == "render":
        assert [s.attrs["depth"] for s in spans if s.name == "shading" and "depth" in s.attrs
                ] == [0, 1, 2, 3, 4] * 2
        assert sorted(s.attrs["index"] for s in spans if s.name == "render.pass") == [0, 1]
    else:
        steps = [s for s in spans if s.name == "optimize.step"]
        assert [s.attrs["step"] for s in steps] == [0, 1] and steps[0].call != steps[1].call
        assert got["host_reads"]["diff/inverse.py:optimize float(loss)"] == 2


@pytest.mark.parametrize("sampler", ["independent", "pmj02bn"])
def test_images_are_bit_for_bit_with_the_tracer_on(sampler, scenes):
    arrays, static = scenes[sampler]
    off = render_t.render(arrays, static, device="cpu")
    on, got = traced(lambda: render_t.render(arrays, static, device="cpu"))
    assert got["spans"] and got["rays"] > 0
    assert torch.equal(off, on)


# each spied read: (file of the package, function, kind) -> the sites that count it
SPIED = {
    ("core/rng.py", "permute", "as_tensor"): ["core/rng.py:permute as_tensor(l)"],
    ("core/rng.py", "_all_accepted", "bool"): ["core/rng.py:permute ok.all()"],
    ("accel/cluster_trace.py", "pack_rays", "as_tensor"): [
        "accel/cluster_trace.py:pack_rays as_tensor(mint)",
        "accel/cluster_trace.py:pack_rays as_tensor(maxt)"],
    ("integrate/camera.py", "sample_ray", "tensor"): [
        "integrate/camera.py:sample_ray torch.tensor"],
    ("shade/ggx.py", "sample_vndf", "tensor"): ["shade/ggx.py:sample_vndf torch.tensor"],
    ("samplers/tables.py", "dev", "as_tensor"): [
        "samplers/tables.py:make_pmj02bn_spec as_tensor"],
}


@pytest.fixture(scope="module")
def spied(scenes):
    """A pmj02bn render with the tracer on and every host read of a tensor
    (``bool``, ``float``, ``int``, ``item``, ``tolist``) and every copy of a
    host value by ``torch.tensor`` or ``torch.as_tensor`` counted by the
    function of the package that made it. Returns (spied counts, collected)."""
    calls = {}
    package = metrics.__file__.rsplit("utils", 1)[0]

    def spy(kind, real, only_host_values=False):
        def wrapped(*args, **kwargs):
            frame = sys._getframe(1)
            if frame.f_code.co_filename.startswith(package) and not (
                    only_host_values and isinstance(args[0], torch.Tensor)):
                key = (frame.f_code.co_filename[len(package):], frame.f_code.co_name, kind)
                calls[key] = calls.get(key, 0) + 1
            return real(*args, **kwargs)
        return wrapped

    arrays, static = scenes["pmj02bn"]
    metrics.collect()
    with pytest.MonkeyPatch.context() as mp, metrics.tracing():
        mp.setattr(torch, "as_tensor", spy("as_tensor", torch.as_tensor, True))
        mp.setattr(torch, "tensor", spy("tensor", torch.tensor))
        for name, kind in (("__bool__", "bool"), ("__float__", "float"), ("__int__", "int"),
                           ("item", "item"), ("tolist", "tolist")):
            mp.setattr(torch.Tensor, name, spy(kind, getattr(torch.Tensor, name)))
        render_t.render(arrays, static, device="cpu")
    return calls, metrics.collect()


@pytest.mark.parametrize("read", [*SPIED, "every read"], ids=lambda r: "-".join(r)
                         if isinstance(r, tuple) else r)
def test_host_reads_count_each_wrapped_read(read, spied):
    calls, got = spied
    reads = got["host_reads"]
    if read == "every read":
        assert sum(calls.values()) == sum(reads.values()), sorted(calls.items())
        assert set(calls) == set(SPIED)
    else:
        assert calls.get(read, 0) > 0
        assert calls[read] == sum(reads.get(site, 0) for site in SPIED[read])


@pytest.fixture(scope="module")
def profiled(scenes):
    """A render under torch.profiler with the tracer on: (spans, the
    profiler's host events named kazen:...). The garbage collector and the
    interpreter's thread switches are held off meanwhile: a pause between a
    span's clock read and its range's end would show as a gap of clocks."""
    from torch.profiler import ProfilerActivity, profile

    arrays, static = scenes["independent"]
    metrics.collect()
    interval = sys.getswitchinterval()
    gc.collect()
    gc.disable()
    sys.setswitchinterval(10.0)
    try:
        with metrics.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
            render_t.render(arrays, static, device="cpu")
    finally:
        sys.setswitchinterval(interval)
        gc.enable()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(metrics.PREFIX)]
    return metrics.collect()["spans"], events


@pytest.mark.parametrize("name", ["sampler.draw", "shading", "trace.nearest", "trace.any_hit"])
def test_span_times_are_on_the_profilers_clock(name, profiled):
    """Each span starts and ends within 1 ms of its profiler range, in the
    median over the render's spans of that name: the scheduler can pause
    the process between a span's clock read and the profiler's own stamp,
    while a clock apart would move every span."""
    spans, events = profiled
    mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
    theirs = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                    if e.name() == metrics.PREFIX + name)
    assert len(mine) >= 10 and len(mine) == len(theirs)
    starts = [abs(s0 - e0) for (s0, _), (e0, _) in zip(mine, theirs)]
    ends = [abs(s1 - e1) for (_, s1), (_, e1) in zip(mine, theirs)]
    assert statistics.median(starts) < 1e6 and statistics.median(ends) < 1e6, (starts, ends)


# the host reads of one con-2 pass by site (PERF.md §5): the texture routes
# move none of them
CON2_READS_PER_PASS = {
    "core/rng.py:permute as_tensor(l)": 33, "core/rng.py:permute ok.all()": 33,
    "accel/cluster_trace.py:pack_rays as_tensor(mint)": 5,
    "shade/ggx.py:sample_vndf torch.tensor": 5, "integrate/camera.py:sample_ray torch.tensor": 1,
}


@pytest.mark.parametrize("scene", ["con2", "textured"])
def test_texture_lookups_count_each_route(scene):
    """The texture_lookups counter by field and route, one 1-pass render:
    con-2's materials texture no field, so every lookup takes the constant
    route, and its host reads stay 77 a pass; the textured scene's base,
    roughness and normal fields take the image route, its constant metallic
    the constant one. With the tracer off nothing is counted."""
    if scene == "con2":
        desc = bc.at_size(bc.config_scene(4, spp=1), 32, 18)
        textured = ()
    else:
        desc = to_port(textured_scene(16, 16, spp=1, composite=False))
        textured = ("base", "roughness", "normal")
    arrays, static = compile_scene(desc, device="cpu")
    assert static.has_image_textures and static.textured_fields == textured
    metrics.collect()
    render_t.render(arrays, static, device="cpu")
    assert metrics.collect()["texture_lookups"] == {}
    _, got = traced(lambda: render_t.render(arrays, static, device="cpu"))
    lookups = got["texture_lookups"]
    fields = {"base", "metallic", "roughness"} | ({"normal"} if textured else set())
    assert set(lookups) == fields
    for field, routes in lookups.items():
        if field in textured:
            assert routes["image"] > 0 and routes["constant"] == 0, (field, routes)
        else:
            assert routes["image"] == 0 and routes["constant"] > 0, (field, routes)
    if scene == "con2":
        reads = {k: v for k, v in got["host_reads"].items() if not k.startswith("samplers/")}
        assert reads == CON2_READS_PER_PASS
        assert sum(reads.values()) == 77


def test_render_metrics_read_once_when_the_call_ends(scenes):
    arrays, static = scenes["pmj02bn"]
    m = metrics.RenderMetrics()
    _, got = traced(lambda: render_t.render(arrays, static, device="cpu", metrics=m))
    assert got["host_reads"]["utils/metrics.py:RenderMetrics.finish"] == 1
    passes = [s for s in got["spans"] if s.name == "render.pass"]
    assert [p.sample_index for p in m.passes] == [0, 1]
    assert all(p.seconds > 0 and p.lanes == SIZE * SIZE for p in m.passes)
    assert sum(p.rays for p in m.passes) == got["rays"] > len(passes) * SIZE * SIZE


def test_shade_route_counts_each_bounce(scenes, tmp_path):
    """The shade_route counter: on the CPU every bounce takes the plain
    route, 5 a pass (depth 5, 2 passes), each counted by its reason in
    shade_plain_reason; with the tracer off nothing is counted; the Chrome
    trace carries both."""
    arrays, static = scenes["pmj02bn"]
    assert static.max_depth == 5
    metrics.collect()
    render_t.render(arrays, static, device="cpu")
    got = metrics.collect()
    assert got["shade_route"] == {} and got["shade_plain_reason"] == {}
    _, got = traced(lambda: render_t.render(arrays, static, device="cpu"))
    assert got["shade_route"] == {"plain": 5 * 2}
    assert got["shade_plain_reason"] == {"CPU tensors": 5 * 2}
    path = tmp_path / "trace.json"
    metrics.write_chrome_trace(str(path), got)
    other = json.loads(path.read_text())["otherData"]
    assert other["shade_route"] == {"plain": 10}
    assert other["shade_plain_reason"] == {"CPU tensors": 10}


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_env_nee_and_beckmann_lobes_count_each_bounce(route, tmp_path, monkeypatch):
    """The env_nee and beckmann_lobes counters by route, one 1-pass render
    of the Textured box (an importance-sampled sky, three rough* quads) at
    depth 4: on the CPU the plain route counts each of its bounces once in
    both; with the shade kernel's source built for the host in the card's
    library's place, the kernel route counts each launch; con-2 (a sky
    looked up on escape, no rough* material) counts nothing; off, nothing
    is counted; the Chrome trace carries both."""
    import shade_host

    if route == "kernel":
        shade_host.kernel_on_host(monkeypatch, shade_host.build(tmp_path))
    arrays, static = compile_scene(to_port(textured_scene(8, 8, spp=1, composite=False)),
                                   device="cpu")
    assert static.env_importance and static.max_depth == 4
    metrics.collect()
    render_t.render(arrays, static, device="cpu")
    got = metrics.collect()
    assert got["env_nee"] == {} and got["beckmann_lobes"] == {}
    _, got = traced(lambda: render_t.render(arrays, static, device="cpu"))
    assert got["shade_route"] == {route: 4}
    assert got["env_nee"] == {route: 4} and got["beckmann_lobes"] == {route: 4}
    path = tmp_path / "trace.json"
    metrics.write_chrome_trace(str(path), got)
    other = json.loads(path.read_text())["otherData"]
    assert other["env_nee"] == other["beckmann_lobes"] == {route: 4}
    con2 = compile_scene(bc.at_size(bc.config_scene(4, spp=1), 8, 8), device="cpu")
    _, got = traced(lambda: render_t.render(*con2, device="cpu"))
    assert got["env_nee"] == {} and got["beckmann_lobes"] == {}


def span(name, sid, parent, start_ms, end_ms, device_ms=None, **attrs):
    s = metrics.Span(name, attrs)
    s.id, s.parent, s.call = sid, parent, 1
    s.start_ns, s.end_ns, s.device_ms = int(start_ms * 1e6), int(end_ms * 1e6), device_ms
    return s


def two_passes():
    """A call of two passes: tables 0-20 ms; pass 0 20-120 ms (device 110)
    with syncs of 5 and 3 ms, one inside a sampler draw; pass 1 120-200 ms
    (device 90) with one sync of 10 ms."""
    return {"spans": [
        span("render.call", 1, None, 0, 200),
        span("sampler.tables", 2, 1, 0, 20),
        span("sync", 3, 2, 1, 2, site="tables"),  # outside the passes
        span("render.pass", 4, 1, 20, 120, 110.0, index=0),
        span("sampler.draw", 5, 4, 30, 40),
        span("sync", 6, 5, 31, 36, site="permute"),
        span("sync", 7, 4, 50, 53, site="pack_rays"),
        span("render.pass", 8, 1, 120, 200, 90.0, index=1),
        span("sync", 9, 8, 130, 140, site="permute"),
    ], "host_reads": {}, "launches": {}, "rays": 0.0}


@pytest.mark.parametrize("reading, value", [
    ("syncs_per_pass", 1.5),
    ("syncs_by_site", {"pack_rays": 0.5, "permute": 1.0}),
    ("host_blocked_ms_per_pass", 9.0),
    ("host_enqueue_ms_per_pass", 81.0),  # the median of 100 - 8 and 80 - 10
    ("pass_device_ms", 100.0),
    ("sampler_tables_ms_per_call", 20.0),
    ("sampler_tables_blocked_ms_per_call", 1.0),
])
def test_pass_split_readings(reading, value):
    assert pass_split.split(two_passes())[reading] == pytest.approx(value)


@pytest.mark.parametrize("activities, want", [
    ([(45e6, 53.5e6, "void at::native::elementwise_kernel<4>(F)"),
      (70e6, 80e6, "nearest_kernel<true>")], ["render.pass -> nearest_kernel", 16.5]),
    ([(25e6, 31.5e6, "a"), (34e6, 40e6, "b")], ["sync permute -> b", 2.5]),
    ([(201e6, 210e6, "a"), (230e6, 240e6, "splat_kernel")],
     [pass_split.OTHER + " -> splat_kernel", 20.0]),
], ids=["pass", "sync", "fallback"])
def test_idle_gaps_are_named_by_the_hosts_span(activities, want):
    got = pass_split.name_gaps([(int(s), int(e), n) for s, e, n in activities],
                               two_passes()["spans"])
    assert got["gaps"] == [[want[0], pytest.approx(want[1])]]
    assert list(got["by_span"]) == [want[0].split(" -> ")[0]]


def test_setup_split():
    got = pass_split.setup_split({"spans": [
        span("compile_scene", 1, None, 0, 1500), span("render.call", 2, None, 1600, 4600),
        span("cuda_build", 3, 2, 1700, 3700, stem="libkz")]})
    assert got == pytest.approx({"compile_scene_s": 1.5, "cuda_build_s": 2.0, "warmup_s": 1.0})
