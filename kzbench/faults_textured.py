"""Faults planted in the Textured configuration's compiled scene, to see
the check fail where only this configuration's mechanisms read: each is a
context manager that alters one table ``scene/compiler.py:compile_scene``
returns while it is open, which the shade kernel's tables and the plain
version both read.

* ``beckmann_alpha``: the rough* materials' Beckmann alpha 5% too large;
* ``env_pdf``: the environment sampler's per-texel pdf 5% too large.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

FAULTS = ("beckmann_alpha", "env_pdf")


def _alter(arrays, fault):
    if fault == "beckmann_alpha":
        from kazen_tpu_torch.shade.bounce_kernel import ROUGH_BTYPES

        mt = arrays.materials
        rough = sum(mt.btype == t for t in ROUGH_BTYPES).bool()
        alpha = mt.alpha * (1.0 + 0.05 * rough.to(mt.alpha.dtype))
        return dataclasses.replace(arrays, materials=dataclasses.replace(mt, alpha=alpha))
    return dataclasses.replace(arrays, env_pdf=arrays.env_pdf * 1.05)


@contextmanager
def planted(fault: str):
    """``compile_scene`` returning its scene with ``fault`` planted."""
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r} for the Textured configuration")
    import kazen_tpu_torch.scene.compiler as compiler

    orig = compiler.compile_scene

    def broken(*args, **kwargs):
        arrays, static = orig(*args, **kwargs)
        return _alter(arrays, fault), static

    compiler.compile_scene = broken
    try:
        yield
    finally:
        compiler.compile_scene = orig
