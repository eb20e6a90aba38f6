"""Plain PyTorch version of the fused CPADMM iteration tail."""

from __future__ import annotations

import torch


def _eta(v: torch.Tensor, gamma) -> torch.Tensor:
    return torch.sign(v) * torch.clamp(v.abs() - gamma, min=0.0)


def cpadmm_tail_ref(x, cx, d_diag, pty, mu, nu, rho, gamma, tau1, tau2):
    """(v, z, mu', nu') — the Alg. 3 elementwise tail after x and Cx.

    v   = D (P^T y + rho (Cx - mu))
    z   = eta_gamma(x + nu)           with gamma = alpha / sigma
    mu' = mu + tau1 (v - Cx)
    nu' = nu + tau2 (x - z)
    """
    v = d_diag * (pty + rho * (cx - mu))
    z = _eta(x + nu, gamma)
    mu_new = mu + tau1 * (v - cx)
    nu_new = nu + tau2 * (x - z)
    return v, z, mu_new, nu_new
