"""The reference's fit: the target image, and the first steps of Adam, in
plain PyTorch (the frozen copy in ``kz/``, every ray traced by brute
force).

``target_image`` renders the configuration with the fit's true values
under no gradient: the target both sides fit. ``follow`` runs the
program's first steps on the reference's own compiled scene: each step
renders the step's sample passes, takes the mean L2 to the target,
backpropagates, steps Adam and clips. It returns each step's loss, the
first step's gradient of each parameter, and each parameter's change
after the last step. ``precision="bfloat16"`` is the control.
"""
from __future__ import annotations

import dataclasses

import torch

from .kz.diff import inverse as inv
from .render import compile_reference, precision_of, sampler_spec


def with_truth(arrays, truth: dict):
    """``arrays`` with the fit's true values: ``roughness`` is the last
    mesh's (the sphere's) material roughness."""
    if set(truth) - {"roughness"}:
        raise ValueError(f"the reference knows no true value of {sorted(set(truth))}")
    if "roughness" in truth:
        rough = arrays.materials.roughness.clone()
        rough[int(arrays.mesh_material[-1])] = truth["roughness"]
        arrays = dataclasses.replace(arrays, materials=dataclasses.replace(arrays.materials,
                                                                           roughness=rough))
    return arrays


def target_image(build, config: dict, device, truth: dict, passes: int) -> torch.Tensor:
    """The (H, W, 3) image of ``passes`` sample passes with ``truth``."""
    arrays, static = compile_reference(build, config, device)
    spec = sampler_spec(static, device)
    with torch.no_grad():
        return inv.render_image(with_truth(arrays, truth), static, spec, {}, list(range(passes)))


def follow(build, config: dict, target: torch.Tensor, device, keys, steps: int, lr: float,
           spp_per_step: int, precision: str = "float32") -> dict:
    """``steps`` Adam steps on the parameter groups ``keys`` from the
    compiled scene: {"losses": [...], "grad": {name: first gradient},
    "change": {name: change after the last step}} (tensors on the host)."""
    arrays, static = compile_reference(build, config, device)
    spec = sampler_spec(static, device)
    params = inv.get_params(arrays, keys)
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.Adam([params[k] for k in sorted(params)], lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses, grad = [], {}
    with precision_of(precision):
        for it in range(steps):
            opt.zero_grad(set_to_none=True)
            samples = inv.step_samples(it, spp_per_step, spec.effective_sample_count)
            loss = inv.image_loss(inv.render_image(arrays, static, spec, params, samples), target)
            loss.backward()
            if it == 0:
                grad = {k: (v.grad.detach().clone() if v.grad is not None
                            else torch.zeros_like(v)).cpu() for k, v in params.items()}
            opt.step()
            inv.clip_params(params)
            losses.append(float(loss.detach()))
            del loss
    change = {k: (params[k].detach() - start[k]).cpu() for k in params}
    return {"losses": losses, "grad": grad, "change": change}
