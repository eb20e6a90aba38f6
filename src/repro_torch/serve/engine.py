"""The continuous-batching engine: one bucket's slots, recycled mid-run.

Port of ``repro/serve/engine.py``.  A :class:`BatchEngine` owns ``slots``
lanes of one batched solver: every lane shares the bucket's operator,
method and execution plan, but carries its *own* convergence contract
(per-slot ``tol`` / ``min_iters`` / ``max_iters``, the contract
:func:`repro_torch.core.solvers.solve_until` has for exactly this).  The
engine advances all lanes together in *rounds* of ``round_iters`` masked
iterations, then hands control back to the host scheduler, which

  1. **harvests** lanes that went inactive (converged, budget-exhausted, or
     deadline-expired): their iterate rows become results, and
  2. **recycles** the freed lanes: a queued request is admitted *mid-run*
     with the slot's solver state, ``delta`` and iteration age re-armed
     (:func:`repro_torch.core.solvers.rearm_slots`), so the batch never
     drains to its stragglers.

Because freezing and re-arming are per-slot selects, a recycled lane
computes what a solo :func:`solve_until` run would.

**Static buffers.**  ``y`` (slots, y_len), ``tol``, ``min_iters``,
``max_iters`` and the :class:`~repro_torch.core.solvers.UntilState` carry
are allocated once; admission and parking write into them in place.  Every
round rebuilds the stepper from the ``y`` buffer, as the reference rebuilds
it under its trace: CPADMM's setup folds ``y`` into ``P^T y``, so a stepper
built once would keep solving the old measurements.

**One CUDA graph per engine** (the counterpart of the reference's one XLA
program per engine: admission never recompiles).  For a local plan whose
operator lies on a CUDA device, one round (the stepper rebuild,
``round_iters`` masked :func:`until_step` calls and the extract) runs once
on a side stream to warm up (Triton compiles, the CUDA libraries load,
cuFFT makes its plans) and is then captured and replayed every round.  The
replay always runs all ``round_iters`` steps where the reference's loop
leaves once no lane is active; the extra steps are exact no-ops (a frozen
lane keeps its state, age and delta), so results, iteration counts and
``stats["slot_iters"]`` are the reference's.  ``idle_steps`` counts the
steps replayed after every lane had finished.

**Eager rounds** run on the CPU and on a distributed plan (gloo collectives
cannot be captured; NCCL capture across the exchange is not done): the same
round, leaving early when no lane is active, as the reference's loop does.

Harvest reads every lane's ``age`` and ``delta`` with one device-to-host
copy a round; ``tol`` / ``min_iters`` / ``max_iters`` are mirrored on the
host as they are written.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.solvers import (
    RecoveryProblem,
    UntilState,
    make_stepper,
    rearm_slots,
    until_active,
    until_init,
    until_step,
)
from ..kernels.circulant_matvec.ops import circulant_matvec_direct
from ..kernels.cpadmm_tail.ops import fused_cpadmm_tail
from ..kernels.soft_threshold.ops import fused_ista_update
from ..kernels.spectral_pointwise.ops import spectral_update
from .request import RecoveryRequest, RecoveryResult

# the wrappers a local round can launch; a captured round adds the launches
# its capture recorded to their counters on every replay
_ROUND_KERNELS = (spectral_update, fused_cpadmm_tail, circulant_matvec_direct,
                  fused_ista_update)


def _leaves(u: UntilState) -> list:
    return list(u.state) + [u.age, u.delta]


def _assign(dst: UntilState, src: UntilState) -> None:
    """Write ``src`` into the static carry ``dst`` in place."""
    if src is dst:
        return
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def _cloned(u: UntilState) -> UntilState:
    """A carry whose every leaf is its own tensor (an init state may share
    one zero tensor between its fields, which in-place writes must not)."""
    return UntilState(state=type(u.state)(*(t.clone() for t in u.state)),
                      age=u.age.clone(), delta=u.delta.clone())


class BatchEngine:
    """``slots`` lanes of one batched solver, recycled round by round."""

    def __init__(
        self,
        op: Any,
        plan: Any,
        method: str = "cpadmm",
        slots: int = 8,
        round_iters: int = 32,
        alpha: float = 1e-4,
        rho: float = 0.1,
        sigma: float = 0.1,
        bucket: str = "",
    ):
        self.op = op
        self.plan = plan
        self.method = method
        self.slots = int(slots)
        self.round_iters = int(round_iters)
        self.alpha, self.rho, self.sigma = alpha, rho, sigma
        self.bucket = bucket

        distributed = plan is not None and plan.is_distributed
        # the drivers' measurement convention: length-m rows locally,
        # scattered full-length rows (P^T y) on a mesh; requests arrive as
        # length-m and are scattered at admission when needed
        self._y_len = op.n if distributed else op.m
        self._scatter = distributed
        col = getattr(op, "circ", op).col
        dtype, device = col.dtype, col.device
        self._y = torch.zeros((self.slots, self._y_len), dtype=dtype, device=device)

        # per-slot convergence contracts; empty slots are parked with
        # max_iters = 0, which until_active treats as never active
        self._tol = torch.full((self.slots,), math.inf, dtype=dtype, device=device)
        self._min = torch.zeros((self.slots,), dtype=torch.int32, device=device)
        self._max = torch.zeros((self.slots,), dtype=torch.int32, device=device)
        # their host mirrors, and age / delta as the last round left them
        self._tol_h = np.full((self.slots,), np.inf, dtype=np.float32)
        self._min_h = np.zeros((self.slots,), dtype=np.int64)
        self._max_h = np.zeros((self.slots,), dtype=np.int64)
        self._age_h = np.zeros((self.slots,), dtype=np.int64)
        self._delta_h = np.full((self.slots,), np.inf, dtype=np.float64)

        # host-side slot metadata
        self._requests: List[Optional[RecoveryRequest]] = [None] * self.slots
        self._admitted_at: List[Optional[float]] = [None] * self.slots
        self._slot_used = [False] * self.slots

        self.stats: Dict[str, int] = {
            "admitted": 0,  # requests that reached a slot
            "recycled": 0,  # admissions into a lane freed mid-run
            "rounds": 0,  # round launches
            "slot_iters": 0,  # sum of per-slot iterations actually stepped
        }
        self.idle_steps = 0  # replayed steps after every lane had finished

        # the init carry: solver-state zeros + age 0 + delta inf, both the
        # engine's starting point and the value re-armed into recycled slots
        # (solver inits do not depend on y, so one init serves every request)
        stepper0 = self._build_stepper()
        u0, self._batch = until_init(stepper0)
        self._u = _cloned(u0)
        self._u_init = _cloned(u0)
        self._x = stepper0.extract(u0.state).clone()  # (slots, n) last extract
        self._age_delta = torch.empty((2, self.slots), dtype=torch.float64, device=device)

        # CUDA events around each replay when ``timing`` is set: (start, end)
        self.timing = False
        self.replay_events: list = []
        self.graphed = device.type == "cuda" and not distributed
        self._graph = None
        if self.graphed:
            self._capture(device)

    def _build_stepper(self):
        return make_stepper(RecoveryProblem(op=self.op, y=self._y), self.method,
                            alpha=self.alpha, rho=self.rho, sigma=self.sigma, plan=self.plan)

    # -- the round ---------------------------------------------------------
    def _round_body(self, leave_early: bool) -> None:
        """One round on the static buffers: rebuild the stepper from ``y``,
        step up to ``round_iters`` times, write the carry, the extract and
        (age, delta) back in place."""
        stepper = self._build_stepper()
        u = self._u
        for _ in range(self.round_iters):
            if leave_early and not bool(until_active(u, self._tol, self._min, self._max).any()):
                break
            u = until_step(stepper, u, self._tol, self._min, self._max, self._batch)
        _assign(self._u, u)
        self._x.copy_(stepper.extract(u.state))
        self._age_delta.copy_(torch.stack([u.age.to(torch.float64),
                                           u.delta.to(torch.float64)]))

    def _capture(self, device: torch.device) -> None:
        """Warm the round up on a side stream (every slot is parked, so the
        warm-up steps change no state), then capture it as a CUDA graph."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._round_body(leave_early=False)
        torch.cuda.current_stream(device).wait_stream(side)
        before = [w.launches for w in _ROUND_KERNELS]
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._round_body(leave_early=False)
        # a capture records the launches and runs none: each replay runs them
        self._replay_launches = [w.launches - b for w, b in zip(_ROUND_KERNELS, before)]
        for w, b in zip(_ROUND_KERNELS, before):
            w.launches = b

    def run_round(self) -> None:
        """Advance every active lane up to ``round_iters`` masked iterations."""
        if not self.busy:
            return
        if self._graph is not None:
            if self.timing:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            self._graph.replay()
            if self.timing:
                ev[1].record()
                self.replay_events.append(ev)
            for w, n in zip(_ROUND_KERNELS, self._replay_launches):
                w.launches += n
        else:
            self._round_body(leave_early=True)
        age_before = self._age_h
        # the round's one device-to-host copy (a copy on the CPU too: the
        # mirrors must not alias the static buffer)
        age_delta = self._age_delta.to("cpu", copy=True).numpy()
        self._age_h = age_delta[0].astype(np.int64)
        self._delta_h = age_delta[1]
        stepped = self._age_h - age_before
        self.stats["rounds"] += 1
        self.stats["slot_iters"] += int(stepped.sum())
        if self._graph is not None:
            self.idle_steps += self.round_iters - int(stepped.max())

    # -- occupancy ---------------------------------------------------------
    @property
    def busy(self) -> bool:
        return any(r is not None for r in self._requests)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._requests) if r is None]

    # -- admission ---------------------------------------------------------
    def admit(self, slot: int, req: RecoveryRequest, now: float) -> None:
        """Place ``req`` into a free slot, re-arming that lane's state."""
        if self._requests[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied")
        y = torch.as_tensor(req.y, dtype=self._y.dtype, device=self._y.device)
        if self._scatter and y.shape[-1] != self._y_len:
            y = self.op.project_back(y)
        if y.shape[-1] != self._y_len:
            raise ValueError(
                f"request {req.request_id!r}: measurement length {y.shape[-1]} does not "
                f"fit this bucket's operator (expects {self._y_len})"
            )
        self._y[slot].copy_(y)
        self._set_contract(slot, req.tol, req.min_iters, req.max_iters)
        admit = torch.zeros((self.slots,), dtype=torch.bool, device=self._y.device)
        admit[slot] = True
        _assign(self._u, rearm_slots(self._u, self._u_init, admit, self._batch))
        self._age_h[slot], self._delta_h[slot] = 0, np.inf
        self._requests[slot] = req
        self._admitted_at[slot] = now
        self.stats["admitted"] += 1
        if self._slot_used[slot]:
            self.stats["recycled"] += 1
        self._slot_used[slot] = True

    def _set_contract(self, slot: int, tol: float, min_iters: int, max_iters: int) -> None:
        self._tol[slot], self._min[slot], self._max[slot] = tol, min_iters, max_iters
        self._tol_h[slot], self._min_h[slot], self._max_h[slot] = tol, min_iters, max_iters

    def park(self, slot: int) -> None:
        """Return a harvested lane to the never-active parked state."""
        self._requests[slot] = None
        self._admitted_at[slot] = None
        self._set_contract(slot, math.inf, int(self._min_h[slot]), 0)

    # -- harvest -----------------------------------------------------------
    def harvest(self, now: float) -> List[RecoveryResult]:
        """Collect finished lanes: converged / budget-exhausted lanes, plus
        any whose deadline has passed (flagged partial results)."""
        if not self.busy:
            return []
        age, delta = self._age_h, self._delta_h
        tol, mn, mx = self._tol_h.astype(np.float64), self._min_h, self._max_h
        out: List[RecoveryResult] = []
        x_host = None
        for i, req in enumerate(self._requests):
            if req is None:
                continue
            inactive = age[i] >= mx[i] or (age[i] >= mn[i] and delta[i] <= tol[i])
            expired = req.deadline is not None and now >= req.deadline
            if not (inactive or expired):
                continue
            if x_host is None:
                x_host = self._x.to("cpu", copy=True)
            converged = bool(delta[i] <= tol[i] and age[i] >= mn[i])
            out.append(RecoveryResult(
                request_id=req.request_id,
                x=x_host[i],
                iterations=int(age[i]),
                delta=float(delta[i]),
                converged=converged,
                deadline_expired=bool(expired and not converged),
                arrival_time=req.arrival_time,
                admitted_time=self._admitted_at[i],
                finish_time=now,
                bucket=self.bucket,
            ))
            self.park(i)
        return out
