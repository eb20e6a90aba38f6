"""Soft-thresholding operator eta_gamma (paper Eq. 4).

``eta_gamma(x) = sign(x) * max(|x| - gamma, 0)``; ``torch.sign(0) == 0``,
as ``jnp.sign`` does.  Port of ``repro/core/soft_threshold.py``.
"""

from __future__ import annotations

import torch


def soft_threshold(x: torch.Tensor, gamma) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - gamma, min=0.0)


def ista_update(x_prev: torch.Tensor, grad_step: torch.Tensor, gamma) -> torch.Tensor:
    """eta_gamma(x_prev + grad_step) — CPISTA Alg. 8 fused tail."""
    return soft_threshold(x_prev + grad_step, gamma)


def admm_z_update(x: torch.Tensor, nu: torch.Tensor, gamma) -> torch.Tensor:
    """z = eta_gamma(x + nu) — CPADMM Alg. 6 line 5."""
    return soft_threshold(x + nu, gamma)
