"""ADMM for LASSO: dense baseline (paper Alg. 2) and circulant CPADMM (Alg. 3).

Port of ``repro/core/admm.py``.

Dense ADMM (the PADMM baseline) pays the O(n^3) inverse of
(A^T A + rho I) up front and keeps the n x n inverse in memory: the cost
profile the paper measures CPADMM against (Figs. 3-4).

CPADMM (scaled-dual form): for A = P C the splitting makes both inner
inverses structured:

    B = (rho C^T C + sigma I)^{-1}   circulant: reciprocal spectrum
    D = (P^T P + rho I)^{-1}         diagonal: 1/(1+rho) on Omega, 1/rho off

so an iteration is two FFT applications plus elementwise work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.spectral import apply_spectrum
from .circulant import DenseOperator, PartialCirculant
from .soft_threshold import soft_threshold

# ---------------------------------------------------------------------------
# Dense ADMM — paper Alg. 2 (the PADMM baseline)
# ---------------------------------------------------------------------------


class DenseAdmmState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor  # the sparse iterate
    u: torch.Tensor  # scaled dual


class DenseAdmmConst(NamedTuple):
    """Per-problem constants: the O(n^2)-memory inverse the paper measures."""

    B: torch.Tensor  # (n, n) = (A^T A + rho I)^{-1}
    Aty: torch.Tensor  # (..., n) = A^T y


def dense_admm_setup(op: DenseOperator, y: torch.Tensor, rho: float) -> DenseAdmmConst:
    """Alg. 2 line 2: the O(n^3) inversion (timed on its own as PADMM-I).

    ``rho`` is added to the gram matrix's diagonal in place, the same
    numbers as the reference's ``A^T A + rho I`` without an n x n identity
    in memory; the inverse is ``torch.linalg.inv`` in the operator's dtype.
    """
    A = op.to_dense()
    gram = A.mT @ A
    gram.diagonal().add_(rho)
    return DenseAdmmConst(B=torch.linalg.inv(gram), Aty=op.rmatvec(y))


def dense_admm_init(op, y: torch.Tensor) -> DenseAdmmState:
    z = y.new_zeros(y.shape[:-1] + (op.n,))
    return DenseAdmmState(x=z, z=z, u=z)


def dense_admm_step(
    const: DenseAdmmConst, state: DenseAdmmState, alpha: float, rho: float, prox=None
) -> DenseAdmmState:
    """Alg. 2 lines 4-6 (``prox=None`` = the paper's soft threshold)."""
    x = torch.matmul(const.Aty + rho * (state.z - state.u), const.B.mT)
    if prox is None:
        z = soft_threshold(x + state.u, alpha / rho)
    else:
        z = prox.apply(x + state.u, alpha / rho)
    return DenseAdmmState(x=x, z=z, u=state.u + x - z)


# ---------------------------------------------------------------------------
# Circulant ADMM — paper Alg. 3 (CPADMM)
# ---------------------------------------------------------------------------


class CpadmmState(NamedTuple):
    x: torch.Tensor  # primal estimate (the recovered signal)
    v: torch.Tensor  # primal splitting variable, v ~= C x
    z: torch.Tensor  # l1 auxiliary
    mu: torch.Tensor  # scaled dual for v = C x
    nu: torch.Tensor  # scaled dual for z = x


class CpadmmConst(NamedTuple):
    b_spec: torch.Tensor  # real rfft spectrum of B = (rho C^T C + sigma I)^{-1}
    d_diag: torch.Tensor  # (n,) diagonal of D = (P^T P + rho I)^{-1}
    Pty: torch.Tensor  # (..., n) = P^T y scattered measurements


class CpadmmParams(NamedTuple):
    alpha: float
    rho: float
    sigma: float
    tau1: float  # dual step, in (0, (sqrt(5)+1)/2) per paper Sec. 4.3
    tau2: float


def cpadmm_setup(op: PartialCirculant, y: torch.Tensor, p: CpadmmParams) -> CpadmmConst:
    """Alg. 3 line 2 — the FFT-based O(n log n) inversion; D by inspection.

    B's spectrum ``1 / (rho |c|^2 + sigma)`` is real and positive, so it is
    kept as its real part: the same numbers as the reference's complex copy
    with zero imaginary part, and the real operand the spectral kernel takes.
    """
    b_spec = op.gram_inverse_spectrum(p.rho, p.sigma).real.contiguous()
    # index_fill_ takes the value as a kernel argument: no host-to-device
    # copy, so the setup can run inside a captured CUDA graph (serve/engine.py)
    d_diag = torch.full((op.n,), 1.0 / p.rho, dtype=y.dtype, device=y.device)
    d_diag.index_fill_(0, op.omega, 1.0 / (1.0 + p.rho))
    return CpadmmConst(b_spec=b_spec, d_diag=d_diag, Pty=op.project_back(y))


def cpadmm_init(op: PartialCirculant, y: torch.Tensor) -> CpadmmState:
    zeros = y.new_zeros(y.shape[:-1] + (op.n,))
    return CpadmmState(x=zeros, v=zeros, z=zeros, mu=zeros, nu=zeros)


def cpadmm_tail(x, cx, d_diag, pty, mu, nu, p, prox=None) -> tuple:
    """The iteration tail after the two circulant applies (x and Cx): the
    v-update, the z-update and both dual updates -> (v, z, mu', nu').

    ``prox=None`` is the paper's soft threshold, under which the whole tail
    is elementwise (the fused ``kernels/cpadmm_tail`` contract).
    """
    v = d_diag * (pty + p.rho * (cx - mu))
    if prox is None:
        z = soft_threshold(x + nu, p.alpha / p.sigma)
    else:
        z = prox.apply(x + nu, p.alpha / p.sigma)
    mu_new = mu + p.tau1 * (v - cx)
    nu_new = nu + p.tau2 * (x - z)
    return v, z, mu_new, nu_new


def cpadmm_step(
    op: PartialCirculant, const: CpadmmConst, state: CpadmmState, p: CpadmmParams,
    prox=None,
) -> CpadmmState:
    """One Alg. 3 iteration (scaled-dual form).

    x-update:  (rho C^T C + sigma I) x = rho C^T (v + mu) + sigma (z - nu)
    v-update:  (P^T P + rho I) v = P^T y + rho (C x - mu)
    z-update:  soft threshold (Alg. 3 line 5)
    duals:     mu += tau1 (v - Cx);  nu += tau2 (x - z)
    """
    C = op.circ
    rhs = p.rho * C.rmatvec(state.v + state.mu) + p.sigma * (state.z - state.nu)
    x = apply_spectrum(const.b_spec, rhs, op.n)
    cx = C.matvec(x)
    v, z, mu, nu = cpadmm_tail(x, cx, const.d_diag, const.Pty, state.mu, state.nu, p, prox=prox)
    return CpadmmState(x=x, v=v, z=z, mu=mu, nu=nu)


def default_cpadmm_params(
    alpha: float = 1e-4, rho: float = 0.1, sigma: float = 0.1, tau: float = 1.0
) -> CpadmmParams:
    """Paper Sec. 6 defaults: alpha = 1e-4, sigma = tau = 1e-1."""
    return CpadmmParams(alpha=float(alpha), rho=float(rho), sigma=float(sigma),
                        tau1=float(tau), tau2=float(tau))
