"""The ``render_textured`` entry: the ``render`` entry's whole frames
through ``render()``, held against the reference of the Textured
configuration (``reference/render_textured.py``: the Beckmann lobes, the
importance-sampled environment and the gaussian film, which
``reference/render.py`` has not).

Set-up, the window's calls, the rate, the traced spans, the sampled pixels,
the comparison and the route check are the ``render`` entry's, and the
window the ``render_con1`` entry's (a traced one captures each launch of
the shade kernel for ``shade_kernel_roofline``). After a traced window, one
1-pass ``render()`` call runs under the program's tracer
(``utils/metrics.py``), outside the timed window, and its counters by
route go to the records (``extra["counters"]``): a program without such a
counter gives none.
"""
from __future__ import annotations

import importlib

from .. import registry
from ..reference import render_textured as ref
from . import render, render_con1
from .render import (  # noqa: F401 (the entry's functions, as the render entry's)
    calls,
    compare,
    end_to_end,
    notes,
    outputs,
    release,
    sample_pixels,
    setup,
)

COUNTERS = ("env_nee", "beckmann_lobes", "shade_route", "shade_plain_reason",
            "texture_footprint")


def _counters(job) -> dict:
    """The program tracer's counters by route over one 1-pass render()."""
    metrics = importlib.import_module("kazen_tpu_torch.utils.metrics")
    render_mod = importlib.import_module("kazen_tpu_torch.integrate.render")
    metrics.collect()
    with metrics.tracing():
        render_mod.render(job.arrays, job.static, spp=1, device=job.device)
    got = metrics.collect()
    return {k: got[k] for k in COUNTERS if k in got}


def window(job, seconds: float, trace: bool) -> None:
    """Render calls back to back for ``seconds`` (the last call finishes);
    a traced window's records also get the counters."""
    render_con1.window(job, seconds, trace)
    if trace:
        job.records.extra["counters"] = _counters(job)


def expected(job, precision: str = "float32"):
    """The reference's (K, 3) values at the checked pixels after the call's
    passes, at the same seed."""
    build = registry.scene(job.config["scene"]).build
    scene, static = ref.compile_reference(build, job.config, job.device)
    targets = sample_pixels(job).to(job.device)
    return ref.pixel_values(scene, static, targets, job.spp, precision).cpu()


def check(job, limits: dict):
    """(readings {name: value}, failed calls), as the render entry's."""
    saved = render.expected
    render.expected = expected
    try:
        return render.check(job, limits)
    finally:
        render.expected = saved
