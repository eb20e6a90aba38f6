"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


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
