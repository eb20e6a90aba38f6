"""Synthetic request streams: seeded Poisson arrivals over one operator.

Port of ``repro/serve/arrivals.py``.  The paper's serving scenario is a
ground-segment receiver draining a stream of compressively sensed signals
(a cheap on-board encoder, all recovery cost at the receiver).  This module
fabricates that stream deterministically: a seeded Poisson process for
arrival times and a seeded per-request signal and convergence-contract
draw.  The arrival times and the tolerance / priority draws come from
numpy's ``default_rng`` exactly as the reference draws them, so they are
bit-equal to the reference's; the sparse signals come from a
``torch.Generator`` (the reference's ``jax.random`` draws cannot be
reproduced), so parity tests carry the reference's stream across through
numpy instead.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.synthetic import paper_regime, sparse_signal
from .request import RecoveryRequest


def poisson_times(seed: int, n: int, rate: float) -> np.ndarray:
    """``n`` arrival times of a rate-``rate``/s Poisson process (seeded)."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def synthetic_workload(
    op,
    n_requests: int,
    rate: float,
    seed: int = 0,
    tols: Sequence[float] = (1e-5, 1e-6),
    max_iters: int = 3000,
    min_iters: int = 50,
    priorities: Sequence[int] = (0,),
    deadline_slack: Optional[float] = None,
    sparsity: Optional[Tuple[int, int]] = None,
    method: str = "cpadmm",
    gen: Optional[torch.Generator] = None,
) -> list:
    """A deterministic request stream over one sensing operator.

    Each request senses a fresh sparse signal through ``op`` and draws its
    convergence contract from ``tols`` (heterogeneous tolerances make
    convergence times ragged, the raggedness slot recycling exploits) and
    its ``priority`` from ``priorities``.  ``deadline_slack`` seconds, if
    given, sets each deadline to ``arrival + slack``.  ``sparsity``
    optionally bounds the support draw ``k in [lo, hi]`` (default: the
    paper-regime k for ``op.n``, exactly).  The signals are drawn in order
    from ``gen`` (default: a CPU generator seeded ``seed + 1000``) and
    placed on the operator's device.
    """
    times = poisson_times(seed, n_requests, rate)
    rng = np.random.default_rng(seed + 1)
    gen = gen if gen is not None else torch.Generator().manual_seed(seed + 1000)
    n = op.n
    device = getattr(op, "circ", op).col.device
    k_paper = paper_regime(n)[1]
    lo, hi = sparsity if sparsity is not None else (k_paper, k_paper)
    out = []
    for i, t in enumerate(times):
        k = int(rng.integers(lo, hi + 1))
        x = sparse_signal(gen, n, k, device=device)
        out.append(RecoveryRequest(
            request_id=f"req-{i:04d}",
            op=op,
            y=op.matvec(x),
            x_true=x,
            tol=float(rng.choice(np.asarray(tols))),
            min_iters=min_iters,
            max_iters=max_iters,
            priority=int(rng.choice(np.asarray(priorities))),
            deadline=None if deadline_slack is None else float(t) + deadline_slack,
            arrival_time=float(t),
            method=method,
        ))
    return out
