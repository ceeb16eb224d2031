"""Texture evaluation, constant path only.

The port of ``kazen_tpu/shade/textures.py`` for scenes whose textures are all
constants: the scene compiler folds each constant into its material row, so
every texture id is -1 and the lookup returns the per-lane constant. Image
and composite textures are not ported yet; a scene that holds one is refused
by the compiler, and this module refuses it again.
"""
from __future__ import annotations

import torch


def eval_texture(static, tex_id: torch.Tensor, const_color: torch.Tensor) -> torch.Tensor:
    """Texture<Color3f>::eval for constant textures: the per-lane constant
    color (``tex_id`` is -1 on every lane)."""
    if getattr(static, "has_image_textures", False) or getattr(
        static, "has_composite_textures", False
    ):
        raise NotImplementedError(
            "image and composite textures are not ported to kazen_tpu_torch yet"
        )
    return const_color
