"""Plain PyTorch version of the banded circulant (blur) matvec."""

from __future__ import annotations

import torch


def banded_circulant_matvec_ref(taps: torch.Tensor, x: torch.Tensor, *, order: int):
    """y[i] = sum_t taps[t] x[(i + t) mod n] by explicit rolls.

    The taps are the circulant's *first row* (a correlation, not a
    convolution): ``taps = [1/L] * L`` gives ``moving_average_blur(n, L)``.
    """
    y = torch.zeros_like(x)
    for t in range(order):
        y = y + taps[t] * torch.roll(x, -t, dims=-1)
    return y
