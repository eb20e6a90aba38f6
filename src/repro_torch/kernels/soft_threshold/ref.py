"""Plain PyTorch versions of the fused soft-threshold kernels."""

from __future__ import annotations

import torch


def eta_ref(v: torch.Tensor, gamma) -> torch.Tensor:
    """sign(v) * max(|v| - gamma, 0); ``torch.sign(0) == 0``."""
    return torch.sign(v) * torch.clamp(v.abs() - gamma, min=0.0)


def ista_threshold_update_ref(x, delta, gamma):
    """eta_gamma(x + delta) — CPISTA's Alg. 1 line 5 (Alg. 8)."""
    return eta_ref(x + delta, gamma)


def ista_step_update_ref(x, grad, tau, alpha):
    """eta_{alpha tau}(x + tau grad) — CPISTA's whole update (Alg. 1 lines
    4-5, Alg. 8) in the folded kernel's order: the threshold ``alpha * tau``
    and the step ``tau * grad`` each rounded in float32, the step before the
    add, then the two shrink branches.  The same numbers as
    ``ista_threshold_update_ref(x, tau * grad, alpha * tau)``."""
    if isinstance(tau, torch.Tensor) or isinstance(alpha, torch.Tensor):
        gamma = alpha * tau  # a Python number takes part in float32
    else:  # both numbers: the float32 product, on the host (no copy to the card)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        gamma = float(f32(alpha) * f32(tau))
    s = x + tau * grad
    return torch.where(s > gamma, s - gamma, torch.where(s < -gamma, s + gamma, 0.0))


def admm_threshold_dual_update_ref(x, nu, gamma, tau2):
    """(z, nu') = (eta_gamma(x + nu), nu + tau2 (x - z)) — Alg. 3 lines 5-6."""
    z = eta_ref(x + nu, gamma)
    return z, nu + tau2 * (x - z)
