"""ISTA / CPISTA / FISTA for LASSO (paper Alg. 1, Sec. 5.2).

Port of ``repro/core/ista.py``.  LASSO objective (paper Eq. 3):
``||y - A x||_2^2 + 2 alpha ||x||_1``; the default step is
``tau = 0.99 / ||A||^2``, exact in O(n) for circulant operators.  The
threshold level is ``alpha * tau`` (the proximal-gradient form of Eq. 3;
see the reference module's note).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .soft_threshold import ista_update


class IstaParams(NamedTuple):
    alpha: float  # l1 weight (paper alpha)
    tau: torch.Tensor | float  # step size


class IstaState(NamedTuple):
    x: torch.Tensor  # current estimate x(t)
    x_prev: torch.Tensor  # previous estimate (FISTA momentum; unused by ISTA)
    t_mom: torch.Tensor  # FISTA momentum t_k, batch-shaped (per signal)


def default_tau(op, safety: float = 0.99) -> torch.Tensor:
    """tau = safety / ||A||_2^2 (paper Alg. 1 initialization)."""
    return safety / op.operator_norm_bound() ** 2


def ista_init(op, y: torch.Tensor) -> IstaState:
    batch = y.shape[:-1]
    x = y.new_zeros(batch + (op.n,))
    # per-signal momentum: a frozen slot keeps the schedule a solo run has
    return IstaState(x=x, x_prev=x, t_mom=y.new_ones(batch))


def _prox_step(v: torch.Tensor, delta: torch.Tensor, gamma, prox) -> torch.Tensor:
    if prox is None:
        return ista_update(v, delta, gamma)  # Alg. 1 line 5
    return prox.apply(v + delta, gamma)


def ista_step(op, y: torch.Tensor, state: IstaState, p: IstaParams, prox=None) -> IstaState:
    """One Alg. 1 iteration: residual -> gradient -> prox."""
    r = y - op.matvec(state.x)  # line 3: residual
    delta = p.tau * op.rmatvec(r)  # line 4: gradient step
    x_new = _prox_step(state.x, delta, p.alpha * p.tau, prox)
    return IstaState(x=x_new, x_prev=state.x, t_mom=state.t_mom)


def fista_step(op, y: torch.Tensor, state: IstaState, p: IstaParams, prox=None) -> IstaState:
    """Beyond-paper Nesterov-accelerated ISTA, same matvec cost; ``t_mom``
    is per signal and broadcasts over each signal's trailing axis."""
    t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * state.t_mom**2))
    beta = (state.t_mom - 1.0) / t_next
    # align with the leading batch axes: a signal may be 1-D or a layout block
    beta = beta.reshape(beta.shape + (1,) * (state.x.ndim - beta.ndim))
    v = state.x + beta * (state.x - state.x_prev)  # extrapolation point
    r = y - op.matvec(v)
    delta = p.tau * op.rmatvec(r)
    x_new = _prox_step(v, delta, p.alpha * p.tau, prox)
    return IstaState(x=x_new, x_prev=state.x, t_mom=t_next)


def lasso_objective(op, y: torch.Tensor, x: torch.Tensor, alpha) -> torch.Tensor:
    """Paper Eq. 3: ||y - Ax||^2 + 2 alpha ||x||_1 (batched over leading axes)."""
    r = y - op.matvec(x)
    return (r * r).sum(dim=-1) + 2.0 * alpha * x.abs().sum(dim=-1)
