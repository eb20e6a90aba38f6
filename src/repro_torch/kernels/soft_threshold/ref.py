"""Plain PyTorch versions of the fused soft-threshold kernels."""

from __future__ import annotations

import torch


def eta_ref(v: torch.Tensor, gamma) -> torch.Tensor:
    """sign(v) * max(|v| - gamma, 0); ``torch.sign(0) == 0``."""
    return torch.sign(v) * torch.clamp(v.abs() - gamma, min=0.0)


def ista_threshold_update_ref(x, delta, gamma):
    """eta_gamma(x + delta) — CPISTA's Alg. 1 line 5 (Alg. 8)."""
    return eta_ref(x + delta, gamma)


def admm_threshold_dual_update_ref(x, nu, gamma, tau2):
    """(z, nu') = (eta_gamma(x + nu), nu + tau2 (x - z)) — Alg. 3 lines 5-6."""
    z = eta_ref(x + nu, gamma)
    return z, nu + tau2 * (x - z)
