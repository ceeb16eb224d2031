"""Faults planted in the program's timed path, to see the check fail.

Each is a context manager that replaces a function of ``kazen_tpu_torch``
(or of torch) while it is open. The tests run a cell at a small size under
each fault that the cell's entry can have and see ``correct`` come out
false; ``control.py --faults`` reads them on the card at a cell's own size.

* ``state_unchanged``: a step that returns its state as it was (a render
  pass leaves the film as it was after the first pass; Adam's step does
  nothing);
* ``half_the_batch``: half the batch left out and the mean taken over the
  rest (a render pass adds the odd lanes' samples of every other pass no
  more; the fit's loss is the mean over the first half of the pixel rows);
* ``altered``: an answer altered where it is made (every 20th lane's
  radiance scaled by 1.01).

A single cell has no exchange between chips to leave out.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

ENTRY_FAULTS = {
    "render": ("state_unchanged", "half_the_batch", "altered"),
    "optimize": ("state_unchanged", "half_the_batch", "altered"),
}


def _render_mod():
    import kazen_tpu_torch.integrate.render as render_mod

    return render_mod


@contextmanager
def _swap(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def _pass_unchanged(orig):
    def broken(scene, static, spec, film, px, py, s, jump, grid_splat=True):
        if s >= 1:
            return film, torch.zeros((), device=film.device)
        return orig(scene, static, spec, film, px, py, s, jump, grid_splat)
    return broken


def _pass_half(orig):
    def broken(scene, static, spec, film, px, py, s, jump, grid_splat=True):
        before = film.clone() if s % 2 == 1 else None
        out, nrays = orig(scene, static, spec, film, px, py, s, jump, grid_splat)
        if before is not None:
            out.view(-1, 4)[1::2] = before.view(-1, 4)[1::2]
        return out, nrays
    return broken


def _li_altered(orig):
    def broken(*args):
        stream, li, nrays = orig(*args)
        li = li.clone()
        li[::20] = li[::20] * 1.01
        return stream, li, nrays
    return broken


def _step_unchanged(orig):
    def broken(self, closure=None):
        return None
    return broken


def _loss_half(orig):
    def broken(img, target):
        h = img.shape[0] // 2
        return orig(img[:h], target[:h])
    return broken


@contextmanager
def planted(entry: str, fault: str):
    """The program with ``fault`` planted for a cell of ``entry``."""
    if fault not in ENTRY_FAULTS[entry]:
        raise ValueError(f"no fault {fault!r} for the {entry} entry")
    render_mod = _render_mod()
    if fault == "altered":
        with _swap(render_mod, "li_wavefront", _li_altered):
            yield
    elif entry == "render":
        make = _pass_unchanged if fault == "state_unchanged" else _pass_half
        with _swap(render_mod, "_render_pass", make):
            yield
    elif fault == "state_unchanged":
        with _swap(torch.optim.Adam, "step", _step_unchanged):
            yield
    else:
        import kazen_tpu_torch.diff.inverse as inv

        with _swap(inv, "image_loss", _loss_half):
            yield
