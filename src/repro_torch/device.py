"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device every entry point uses when given no ``device=``.

    Raises ``RuntimeError`` when CUDA is unavailable: the port never falls
    back to the CPU on its own — a caller who wants the CPU says so.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
