"""Unified recovery driver for the paper's solver family (local backend).

Port of ``repro/core/solvers.py``.  Methods:

    'ista'    Alg. 1 (PISTA on a dense operator, CPISTA on a circulant one)
    'fista'   beyond-paper accelerated variant (same cost per iteration)
    'admm'    Alg. 2 on a DenseOperator (the O(n^3) inverse up front); 'padmm'
              is the same
    'cpadmm'  Alg. 3 on a PartialCirculant (FFT setup + structured iterations)

Drivers: ``solve`` (fixed iteration count, metric traces), ``solve_until``
(relative-change tolerance, per-signal freeze) and ``solve_checkpointed``
(chunks with a ``save_cb`` between them).  Where the reference runs
``lax.scan`` / ``while_loop`` under jit, the port runs a Python loop of
eager steps.  Every driver takes a leading batch axis on ``y`` / ``x_true``
(B signals through one operator); batch-of-1 equals the unbatched run.

``plan=`` (:func:`repro_torch.ops.plan.plan`) selects the backend and the
step's substrate: ``tail='kernel'`` with the l1 prior runs CPADMM,
ISTA/CPISTA and dense ADMM on the hand-written kernels
(:mod:`repro_torch.core.kernel_backend`); FISTA keeps the plain step on
either tail, as the reference has no kernel FISTA step.  With no plan, or
a plan built with the default ``tail=None``, the tail follows the
operands' device (:func:`repro_torch.ops.plan.resolve_tail`): the kernel
steps for a PartialCirculant on the card, the plain steps on the CPU and
for other operators.  A distributed plan (``plan(op, mesh)``) lowers every
method but dense ADMM to the four-step transforms of
:mod:`repro_torch.dist`; the drivers run unchanged on this rank's signals
(the local batch of the data axis), whole.

Recovery success follows the paper: MSE = ||x* - x||^2 / n <= 1e-4 (Sec. 6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..ops.plan import resolve_tail
from ..ops.prox import is_l1
from . import admm as admm_mod
from . import ista as ista_mod
from .circulant import DenseOperator, PartialCirculant
from .kernel_backend import cpadmm_step_kernel, dense_admm_step_kernel, ista_step_kernel

PAPER_TARGET_MSE = 1e-4  # paper Sec. 6 recovery threshold


class RecoveryProblem(NamedTuple):
    op: Any  # matvec/rmatvec-capable operator
    y: torch.Tensor  # (..., m) measurements
    x_true: Optional[torch.Tensor] = None  # (..., n) ground truth (metrics only)


class Trace(NamedTuple):
    objective: torch.Tensor  # (T, ...) LASSO objective per recorded step
    mse: torch.Tensor  # (T, ...) MSE vs x_true (nan if no truth)
    nnz: torch.Tensor  # (T, ...) support size of the iterate


def _metric_view(problem: RecoveryProblem, plan) -> RecoveryProblem:
    """The problem the metrics are computed against: on a distributed plan,
    this rank's signals through the plan's mask-form operator, so metric
    matvecs run on the mesh too."""
    if plan is None or not plan.is_distributed:
        return problem
    x_true = None if problem.x_true is None else plan.local_batch(problem.x_true)
    return RecoveryProblem(op=plan.operator, y=plan._scattered_measurements(problem),
                           x_true=x_true)


def _metrics(problem: RecoveryProblem, x: torch.Tensor, alpha):
    obj = ista_mod.lasso_objective(problem.op, problem.y, x, alpha)
    if problem.x_true is not None:
        d = problem.x_true - x
        mse = (d * d).mean(dim=-1)
    else:
        mse = torch.full_like(obj, math.nan)
    nnz = (x.abs() > 0).sum(dim=-1, dtype=torch.int32)
    return obj, mse, nnz


@dataclasses.dataclass(frozen=True)
class Stepper:
    """An (init, step, extract) triple hiding per-method state shapes."""

    init: Callable[[], Any]
    step: Callable[[Any], Any]
    extract: Callable[[Any], torch.Tensor]  # state -> current x


VALID_METHODS = ("ista", "fista", "cpista", "admm", "padmm", "cpadmm")


def make_stepper(
    problem: RecoveryProblem,
    method: str,
    alpha: float = 1e-4,
    rho: float = 0.1,
    sigma: float = 0.1,
    tau: Optional[float] = None,
    plan=None,
    prox=None,
) -> Stepper:
    """Lower (problem, method) to a Stepper on the plan's backend.

    ``prox=None`` defaults to the plan's ``prox`` and then to the paper's
    soft threshold, which keeps the fused kernel steps eligible; a non-l1
    prox takes the plain step.  ``tail='kernel'`` swaps in the kernel
    steps for 'cpadmm' and 'ista'/'cpista' (a PartialCirculant operator)
    and for 'admm'/'padmm' (a DenseOperator); 'fista' has no kernel step
    and keeps the plain one.  ``plan=None`` takes the tail
    :func:`~repro_torch.ops.plan.resolve_tail` gives the operator, as
    ``plan(op)`` would.  A distributed
    plan builds its own stepper (:meth:`ExecutionPlan.build_stepper`) with
    the same init / step / extract-flat-x contract.
    """
    if prox is None and plan is not None:
        prox = plan.prox
    if plan is not None and plan.is_distributed:
        return plan.build_stepper(problem, method, alpha=alpha, rho=rho, sigma=sigma, tau=tau,
                                  prox=prox)
    op, y = problem.op, problem.y
    tail = plan.tail if plan is not None else resolve_tail(None, op)
    if method in ("ista", "fista", "cpista"):
        tau_v = tau if tau is not None else ista_mod.default_tau(op)
        p = ista_mod.IstaParams(alpha=float(alpha), tau=tau_v)
        if method != "fista" and tail == "kernel" and is_l1(prox):
            if not isinstance(op, PartialCirculant):
                raise TypeError("the kernel ISTA step needs a PartialCirculant operator")
            # the fused threshold kernel bakes in the soft threshold, so it
            # serves the l1 prior only; other priors take the plain step
            step = lambda s: ista_step_kernel(op, y, s, p)
        else:
            step_fn = ista_mod.fista_step if method == "fista" else ista_mod.ista_step
            step = lambda s: step_fn(op, y, s, p, prox=prox)
        return Stepper(
            init=lambda: ista_mod.ista_init(op, y),
            step=step,
            extract=lambda s: s.x,
        )
    if method in ("admm", "padmm"):
        if not isinstance(op, DenseOperator):
            raise TypeError("dense ADMM needs a DenseOperator; use 'cpadmm'")
        alpha, rho = float(alpha), float(rho)
        const = admm_mod.dense_admm_setup(op, y, rho)
        if tail == "kernel" and is_l1(prox):
            # the threshold + dual kernel bakes in the soft threshold (l1 only)
            step = lambda s: dense_admm_step_kernel(const, s, alpha, rho)
        else:
            step = lambda s: admm_mod.dense_admm_step(const, s, alpha, rho, prox=prox)
        return Stepper(
            init=lambda: admm_mod.dense_admm_init(op, y),
            step=step,
            extract=lambda s: s.z,  # z is the sparse iterate
        )
    if method == "cpadmm":
        if not isinstance(op, PartialCirculant):
            raise TypeError("cpadmm needs a PartialCirculant operator")
        t = 1.0 if tau is None else float(tau)
        p = admm_mod.CpadmmParams(
            alpha=float(alpha), rho=float(rho), sigma=float(sigma), tau1=t, tau2=t
        )
        const = admm_mod.cpadmm_setup(op, y, p)
        if tail == "kernel" and is_l1(prox):
            # the fused tail kernel bakes in the soft threshold, so it serves
            # the l1 prior only; other priors take the plain step below
            step = lambda s: cpadmm_step_kernel(op, const, s, p)
        else:
            step = lambda s: admm_mod.cpadmm_step(op, const, s, p, prox=prox)
        return Stepper(
            init=lambda: admm_mod.cpadmm_init(op, y),
            step=step,
            extract=lambda s: s.z,
        )
    raise ValueError(f"unknown method {method!r}; valid methods: {', '.join(VALID_METHODS)}")


def solve(
    problem: RecoveryProblem,
    method: str = "cpadmm",
    iters: int = 200,
    alpha: float = 1e-4,
    record_every: Optional[int] = None,
    plan=None,
    **kw,
) -> Tuple[torch.Tensor, Trace]:
    """Run ``iters // record_every`` blocks of ``record_every`` iterations,
    recording the metric traces after each block.  Each record costs one
    operator application, so ``record_every`` defaults to 1 on one device
    but to ``iters`` on a distributed plan (two more all-to-alls a record)."""
    if record_every is None:
        record_every = iters if plan is not None and plan.is_distributed else 1
    stepper = make_stepper(problem, method, alpha=alpha, plan=plan, **kw)
    metric_problem = _metric_view(problem, plan)
    inner = max(1, record_every)
    outer = max(1, iters // inner)
    state = stepper.init()
    records = []
    for _ in range(outer):
        for _ in range(inner):
            state = stepper.step(state)
        records.append(_metrics(metric_problem, stepper.extract(state), alpha))
    obj, mse, nnz = (torch.stack(r) for r in zip(*records))
    return stepper.extract(state), Trace(objective=obj, mse=mse, nnz=nnz)


def _freeze_converged(new_state, old_state, active: torch.Tensor, batch: Tuple[int, ...]):
    """Keep stepping active signals, freeze converged ones.

    ``active`` has the batch shape; every state field carrying the batch as
    leading dims is masked per signal (the per-signal FISTA momentum too).
    Fields without the batch prefix advance globally.
    """

    def sel(new, old):
        if batch and tuple(new.shape[: len(batch)]) == tuple(batch):
            return torch.where(active.reshape(tuple(batch) + (1,) * (new.ndim - len(batch))),
                               new, old)
        return new

    return type(new_state)(*(sel(a, b) for a, b in zip(new_state, old_state)))


class UntilState(NamedTuple):
    """The tolerance-driven loop's carry, per slot: ``age`` counts iterations
    since (re-)admission and ``delta`` is the last relative iterate change,
    both batch-shaped so a slot can be re-armed mid-run."""

    state: Any  # solver state (fields carry the batch prefix)
    age: torch.Tensor  # (batch,) int32
    delta: torch.Tensor  # (batch,) last relative change (inf before a step)


def until_init(stepper: Stepper) -> Tuple[UntilState, Tuple[int, ...]]:
    """Fresh loop carry for a stepper; returns (carry, batch_shape)."""
    s0 = stepper.init()
    x0 = stepper.extract(s0)
    batch = tuple(x0.shape[:-1])
    return (
        UntilState(
            state=s0,
            age=torch.zeros(batch, dtype=torch.int32, device=x0.device),
            delta=torch.full(batch, math.inf, dtype=x0.dtype, device=x0.device),
        ),
        batch,
    )


def until_active(u: UntilState, tol, min_iters, max_iters) -> torch.Tensor:
    """Per-slot liveness: inside the budget AND (young OR still moving).
    ``tol`` / ``min_iters`` / ``max_iters`` are scalars or per-slot tensors."""
    return (u.age < max_iters) & ((u.age < min_iters) | (u.delta > tol))


def until_step(stepper: Stepper, u: UntilState, tol, min_iters, max_iters,
               batch: Tuple[int, ...]) -> UntilState:
    """One masked iteration: step active slots, freeze the rest, update each
    active slot's age and relative change."""
    active = until_active(u, tol, min_iters, max_iters)
    new = _freeze_converged(stepper.step(u.state), u.state, active, batch)
    x_old = stepper.extract(u.state)
    x_new = stepper.extract(new)
    num = torch.linalg.vector_norm(x_new - x_old, dim=-1)
    den = torch.linalg.vector_norm(x_old, dim=-1) + 1e-12
    return UntilState(
        state=new,
        age=torch.where(active, u.age + 1, u.age),
        delta=torch.where(active, num / den, u.delta),
    )


def rearm_slots(u: UntilState, init: UntilState, admit: torch.Tensor,
                batch: Tuple[int, ...]) -> UntilState:
    """Admit new work: where ``admit``, take the *init* carry (state re-zeroed,
    age 0, delta inf), so the admitted signal runs exactly as it would alone."""
    return UntilState(
        state=_freeze_converged(init.state, u.state, admit, batch),
        age=torch.where(admit, init.age, u.age),
        delta=torch.where(admit, init.delta, u.delta),
    )


def solve_until(
    problem: RecoveryProblem,
    method: str = "cpadmm",
    tol=1e-7,
    max_iters=5000,
    min_iters=50,
    alpha: float = 1e-4,
    plan=None,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterate until the relative iterate change < tol (or max_iters);
    returns (x, iterations_used), both per signal: converged signals freeze
    while the rest keep iterating, and the loop ends when every signal has
    converged.  ``tol`` / ``min_iters`` / ``max_iters`` may be per-signal."""
    stepper = make_stepper(problem, method, alpha=alpha, plan=plan, **kw)
    u, batch = until_init(stepper)
    while bool(until_active(u, tol, min_iters, max_iters).any()):
        u = until_step(stepper, u, tol, min_iters, max_iters, batch)
    return stepper.extract(u.state), u.age


def solve_checkpointed(
    problem: RecoveryProblem,
    method: str = "cpadmm",
    iters: int = 1000,
    chunk: int = 100,
    alpha: float = 1e-4,
    save_cb: Optional[Callable[[int, Any], None]] = None,
    restore: Optional[Tuple[int, Any]] = None,
    plan=None,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``chunk`` iterations at a time, calling ``save_cb(step, state)``
    between chunks; ``restore=(step, state)`` resumes an interrupted run.
    Returns (x, mse)."""
    stepper = make_stepper(problem, method, alpha=alpha, plan=plan, **kw)
    step, state = (0, stepper.init()) if restore is None else restore
    while step < iters:
        for _ in range(chunk):
            state = stepper.step(state)
        step += chunk
        if save_cb is not None:
            save_cb(step, state)
    x = stepper.extract(state)
    _, mse, _ = _metrics(_metric_view(problem, plan), x, alpha)
    return x, mse
