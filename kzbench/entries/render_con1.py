"""The ``render_con1`` entry: the ``render`` entry's whole frames through
``render()``, held against the reference of BASELINE's configuration 3
(``reference/render_con1.py``: the thin lens, the normal map and the
independent sampler, which ``reference/render.py`` has not).

Set-up, the window's calls, the rate, the traced spans, the sampled pixels,
the comparison and the route check are the ``render`` entry's: ``window``
and ``check`` run its functions, ``check`` with this entry's reference in
place of its own. A traced window also captures each launch of the shade
kernel (``bounce_kernel.shade_cuda``) while the profiler runs, with its
bytes bound (``shade_roofline.py``), for ``shade_kernel_roofline``; a
program whose bounces take the plain shade route launches none.
"""
from __future__ import annotations

import importlib
from contextlib import contextmanager

import torch

from .. import registry, shade_roofline
from ..reference import render_con1 as ref
from . import render
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

SHADE_KERNEL = "shade_kernel"


@contextmanager
def _shade_launches(captured: list):
    """``bounce_kernel.shade_cuda`` recording each launch made while the
    profiler runs."""
    bk = importlib.import_module("kazen_tpu_torch.shade.bounce_kernel")
    launch = bk.shade_cuda

    def recorded(*args, **kwargs):
        out = launch(*args, **kwargs)
        if torch.autograd._profiler_enabled():
            captured.append(shade_roofline.launch(args, kwargs))
        return out

    bk.shade_cuda = recorded
    try:
        yield
    finally:
        bk.shade_cuda = launch


def window(job, seconds: float, trace: bool) -> None:
    """Render calls back to back for ``seconds`` (the last call finishes)."""
    if not trace:
        render.window(job, seconds, trace)
        return
    captured = []
    with _shade_launches(captured):
        render.window(job, seconds, trace)
    job.records.launches["K7"] = captured
    job.records.extra["shade_kernel_name"] = SHADE_KERNEL


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
