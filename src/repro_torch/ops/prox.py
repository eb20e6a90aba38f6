"""The prior as a value: the identity-basis l1 prox (paper Eq. 4).

Port of the ``L1Prox`` / ``is_l1`` part of ``repro/ops/prox.py``.  A prox
has ``apply(x, gamma) = argmin_z 0.5 ||z - x||^2 + gamma R(z)`` acting on
the trailing axis, and a stable ``tag``.  TV, wavelet and non-negative l1
come with a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.soft_threshold import soft_threshold


@dataclasses.dataclass(frozen=True)
class L1Prox:
    """Identity-basis l1 soft threshold (paper Eq. 4) — the default prior."""

    @property
    def tag(self) -> str:
        return "l1"

    def apply(self, x: torch.Tensor, gamma) -> torch.Tensor:
        return soft_threshold(x, gamma)


def is_l1(prox) -> bool:
    """True when the prior is the identity-basis soft threshold — the prox
    the fused kernel tails compute, so they stay eligible."""
    return prox is None or type(prox) is L1Prox
