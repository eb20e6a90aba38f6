"""Device choice for the port's entry points, and the ``meta`` device of
the dry runs.

A dry run (:mod:`repro_torch.launch.dryrun`) walks one rank's step on
``meta`` tensors, which have shapes and no values: it prices the card's
program, so every choice the port makes from ``device.type == "cuda"``
takes the card's branch on ``meta`` too (:func:`models_the_card`).  Where
the port reads a value on the host (a buffer size, a guard), a ``meta``
tensor has none: the code takes the static bound the reference compiles
with instead and names it through :func:`static_bound`, which the dry run
records under ``"static_bounds"``.  On a real tensor each read stays as it
is.
"""

from __future__ import annotations

from typing import Dict

import torch

# where -> what bound was taken there, since the last reset_static_bounds()
STATIC_BOUNDS: Dict[str, str] = {}


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def models_the_card(device) -> bool:
    """A CUDA device, or ``meta``, which stands for one in a dry run."""
    return device is not None and torch.device(device).type in ("cuda", "meta")


def static_bound(where: str, what: str) -> None:
    """Note that the code at ``where`` took the static bound ``what`` in
    place of a value a ``meta`` tensor does not have."""
    STATIC_BOUNDS[where] = what


def reset_static_bounds() -> None:
    STATIC_BOUNDS.clear()


def default_device() -> torch.device:
    """The CUDA device every entry point uses when given no ``device=``:
    this process's current CUDA device, which a distributed launcher sets
    per rank (``repro_torch.dist.compat``), so each rank of a ``torchrun``
    job lands on its own card.

    Raises ``RuntimeError`` when CUDA is unavailable: the port never falls
    back to the CPU on its own — a caller who wants the CPU says so.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` and a plain ``"cuda"``
    mean :func:`default_device` (this rank's card).  Any CUDA device
    raises when CUDA is unavailable."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and (device.index is None or not torch.cuda.is_available()):
        current = default_device()
        return current if device.index is None else device
    return device
