"""Request / result dataclasses and clocks for the recovery service.

Port of ``repro/serve/request.py`` (a copy: the port imports nothing of the
reference).  A :class:`RecoveryRequest` is one compressed signal to
recover, with its own convergence contract (``tol`` / ``min_iters`` /
``max_iters``), scheduling hints (``priority``, ``deadline``), and the
sensing operator it was measured through.  The dispatcher
(:mod:`repro_torch.serve.server`) buckets requests whose operator + solver
+ plan agree and packs them into one batched driver.

Time is injectable: the server reads a :class:`Clock`, so tests drive a
:class:`ManualClock` deterministically while the launcher uses the
:class:`WallClock`.  All timestamps (``arrival_time``, ``deadline``, result
times) are seconds on that clock.  ``y`` and ``x`` are torch tensors, and
``plan_config`` is a :class:`repro_torch.ops.plan.PlanConfig`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional


class Clock:
    """The server's notion of time (seconds, monotone)."""

    def now(self) -> float:
        raise NotImplementedError

    def advance_to(self, t: float) -> None:
        """Idle-wait until ``t`` (no-op if already past)."""
        raise NotImplementedError


class WallClock(Clock):
    """Real time, zeroed at construction; idle waits actually sleep."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def advance_to(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class ManualClock(Clock):
    """Deterministic test clock: time moves only when told to."""

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        self._t = max(self._t, float(t))

    def tick(self, dt: float) -> None:
        self._t += float(dt)


@dataclasses.dataclass(frozen=True)
class RecoveryRequest:
    """One signal to recover, with its own convergence/scheduling contract.

    ``y`` is the length-``m`` measurement tensor sensed through ``op`` (a
    batch of requests may share one operator instance; the dispatcher
    buckets on the operator's content fingerprint, so distinct spectra never
    share a batch).  ``priority``: larger runs first under contention.
    ``deadline``: absolute clock time after which the request is returned as
    a *flagged partial result* instead of iterating further (never an
    exception).  ``plan_config`` optionally pins the execution-plan knobs
    for this request's bucket (configs that lower differently are separate
    buckets by construction).
    """

    request_id: str
    op: Any  # RecoveryOperator (matvec/rmatvec/project_back-capable)
    y: Any  # (m,) measurements, a torch tensor
    tol: float = 1e-6
    min_iters: int = 50
    max_iters: int = 3000
    priority: int = 0
    deadline: Optional[float] = None
    arrival_time: float = 0.0
    method: str = "cpadmm"
    plan_config: Any = None  # Optional[repro_torch.ops.plan.PlanConfig]
    x_true: Any = None  # ground truth, metrics only


@dataclasses.dataclass(frozen=True)
class RecoveryResult:
    """What the server returns for one request.

    ``converged`` means the relative-change test passed inside the budget;
    ``deadline_expired`` flags a partial iterate returned because the
    deadline passed (``x`` is the best iterate so far, ``iterations`` how
    far it got; a request whose deadline passes while still queued comes
    back with ``iterations == 0`` and a zero iterate).  ``x`` is a tensor on
    the CPU.
    """

    request_id: str
    x: Any  # (n,) recovered signal (partial if flagged)
    iterations: int
    delta: float  # last relative iterate change (inf if never stepped)
    converged: bool
    deadline_expired: bool
    arrival_time: float
    admitted_time: Optional[float]  # None: never reached a slot
    finish_time: float
    bucket: str  # the bucket key this request was served under

    @property
    def latency(self) -> float:
        """Arrival-to-finish seconds, the p50/p99 quantity."""
        return self.finish_time - self.arrival_time

    @property
    def queue_wait(self) -> float:
        t = self.finish_time if self.admitted_time is None else self.admitted_time
        return t - self.arrival_time
