"""The ``render_preview`` entry: the ``render`` entry's whole frames at the
frame size the traffic gives (``width``, ``height``), for the program and
the reference alike: low-resolution preview renders of a configuration's
scene. Everything else is the ``render`` entry's.
"""
from __future__ import annotations

from . import render
from .render import (  # noqa: F401 (the entry's functions, as the render entry's)
    calls,
    check,
    compare,
    end_to_end,
    expected,
    notes,
    outputs,
    release,
    sample_pixels,
    window,
)


def setup(config: dict, traffic: dict, seed: int, device):
    """The render entry's set-up of ``config`` at the traffic's frame."""
    return render.setup(dict(config, width=int(traffic["width"]), height=int(traffic["height"])),
                        traffic, seed, device)
