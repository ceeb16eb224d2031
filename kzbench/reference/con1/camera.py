"""Camera ray generation (camera.cpp:70-91 perspective, :188-226 thinlens):
a frozen copy of the port's ``integrate/camera.py:sample_ray``, around the
transforms of ``kz/integrate/camera.py``."""
from __future__ import annotations

import torch

from ..kz.accel.intersect import Rays
from ..kz.core import math as km
from ..kz.integrate.camera import _xform_point, _xform_vector
from . import warp


def sample_ray(scene, static, pixel_sample, aperture_sample) -> Rays:
    """World-space camera rays; the importance weight is 1 for both camera
    models (camera.cpp:92, :227)."""
    inv_size = torch.tensor(
        [1.0 / static.width, 1.0 / static.height],
        dtype=torch.float32, device=pixel_sample.device,
    )
    p_sample = pixel_sample * inv_size
    near_p = _xform_point(
        scene.sample_to_camera,
        torch.cat([p_sample, torch.zeros_like(p_sample[..., :1])], -1),
    )
    if static.camera_kind == "thinlens":
        tmp = warp.square_to_uniform_disk(aperture_sample) * scene.aperture_radius
        aperture_p = torch.cat([tmp, torch.zeros_like(tmp[..., :1])], -1)
        focus_p = near_p * (scene.focus_distance / near_p[..., 2:3])
        d_local = km.normalize(focus_p - aperture_p)
        o_local = aperture_p
    else:
        d_local = km.normalize(near_p)
        o_local = torch.zeros_like(near_p)

    inv_z = 1.0 / d_local[..., 2]
    return Rays(
        o=_xform_point(scene.cam_to_world, o_local),
        d=_xform_vector(scene.cam_to_world, d_local),
        mint=scene.cam_near * inv_z,
        maxt=scene.cam_far * inv_z,
    )
