"""The recovery dispatcher: bucket, pack, recycle.

Port of ``repro/serve/server.py``.  :class:`RecoveryServer` is the serving
front end over the batched solvers: requests stream in (:meth:`submit` or
the open-loop :meth:`serve`), are bucketed by everything their batch must
agree on (operator fingerprint, solver method and hyper-parameters, and the
execution-plan config: :meth:`repro_torch.ops.plan.PlanConfig.describe`,
so rfft and full-complex requests, or flat and hierarchical exchanges,
never share a batch), and each bucket runs a
:class:`~repro_torch.serve.engine.BatchEngine` whose converged slots are
recycled to queued requests mid-run.

Scheduling is priority-first (larger ``priority`` wins; FIFO within a
priority), deadlines come back as flagged partial results, and every clock
read goes through the injectable :class:`~repro_torch.serve.request.Clock`.
On a mesh every rank runs the same scheduler over the same stream, so
every decision that reads the clock (admission, queued expiry, deadline
harvest, the arrival cut of :meth:`serve`) must agree on all ranks: each
clock read takes rank 0's time, broadcast to every rank
(:func:`mesh_now`), or the ranks' collectives fall out of step.

``tune=True`` / ``"measure"`` plans a mesh bucket with the autotuner
(:mod:`repro_torch.ops.tune`) for a batch of ``slots`` signals: a warm
store answers in milliseconds once any earlier run tuned the workload.
A request's own ``plan_config`` wins over it, and a local bucket is not
tuned (nothing distributed to tune), as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.plan import PlanConfig, plan
from .engine import BatchEngine
from .request import Clock, RecoveryRequest, RecoveryResult, WallClock


def operator_fingerprint(op) -> str:
    """Content fingerprint of a sensing operator, for bucket isolation.

    Two operators with the same (type, n, m) but different spectra must
    never share a batch (slots would solve against the wrong operator), so
    the key hashes the stored column's prefix and the measurement index
    set, not just the shape.  The bytes are the port's own dtypes (its
    index set is int64, the reference's int32), so a fingerprint names an
    operator within the port, not across the two packages.
    """
    h = hashlib.sha256()
    circ = getattr(op, "circ", op)
    h.update(type(op).__name__.encode())
    h.update(circ.col[:256].detach().cpu().numpy().tobytes())
    omega = getattr(op, "omega", None)
    if omega is not None:
        h.update(omega[:256].detach().cpu().numpy().tobytes())
        h.update(str(int(omega.shape[-1])).encode())
    h.update(str(int(circ.n)).encode())
    return h.hexdigest()[:16]


def mesh_now(clock: Clock, mesh) -> float:
    """``clock.now()``, or on a mesh rank 0's ``now`` on every rank (one
    float64 broadcast), so every rank takes the same scheduling decision."""
    t = clock.now()
    if mesh is None:
        return t
    buf = torch.tensor([t], dtype=torch.float64, device=mesh.device)
    torch.distributed.broadcast(buf, src=0)
    return float(buf.cpu()[0])


def _plan_knobs(cfg: PlanConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


class RecoveryServer:
    """Continuous-batching recovery-as-a-service dispatcher."""

    def __init__(
        self,
        mesh: Any = None,
        slots: int = 8,
        round_iters: int = 32,
        alpha: float = 1e-4,
        rho: float = 0.1,
        sigma: float = 0.1,
        tune: Any = False,
        clock: Optional[Clock] = None,
    ):
        self.mesh = mesh
        self.slots = int(slots)
        self.round_iters = int(round_iters)
        self.alpha, self.rho, self.sigma = alpha, rho, sigma
        self.tune = tune
        self.clock = clock if clock is not None else WallClock()

        self.engines: Dict[str, BatchEngine] = {}
        # bucket key -> heap of (-priority, seq, request); seq keeps FIFO
        # order within a priority level (and makes the heap total-ordered)
        self._queues: Dict[str, list] = {}
        self._seq = 0
        self.results: List[RecoveryResult] = []

    def now(self) -> float:
        """The scheduler's time: this clock's, rank 0's on a mesh."""
        return mesh_now(self.clock, self.mesh)

    # -- bucketing ---------------------------------------------------------
    def bucket_key(self, req: RecoveryRequest) -> str:
        # cfg.describe() carries every plan knob that changes the step:
        # wire_dtype ("wire=bf16"), the hierarchical exchange ("hier=HxD",
        # "hier=flat", "inter_wire=bf16"), the prior
        cfg = req.plan_config
        cfg_tag = cfg.describe() if cfg is not None else f"tune={self.tune}"
        return "|".join([
            f"op={operator_fingerprint(req.op)}",
            f"n={req.op.n}", f"m={req.op.m}",
            f"method={req.method}",
            f"alpha={self.alpha}", f"rho={self.rho}", f"sigma={self.sigma}",
            f"plan[{cfg_tag}]",
        ])

    def _engine_for(self, key: str, req: RecoveryRequest) -> BatchEngine:
        eng = self.engines.get(key)
        if eng is None:
            if req.plan_config is not None:
                pl = plan(req.op, self.mesh, **_plan_knobs(req.plan_config))
            elif self.tune and self.mesh is not None:
                pl = plan(req.op, self.mesh, tune=self.tune, batch=self.slots)
            else:
                pl = plan(req.op, self.mesh)
            eng = BatchEngine(
                req.op, pl, method=req.method, slots=self.slots,
                round_iters=self.round_iters, alpha=self.alpha,
                rho=self.rho, sigma=self.sigma, bucket=key,
            )
            self.engines[key] = eng
        return eng

    def warmup(self, req: RecoveryRequest) -> None:
        """Build ``req``'s bucket (its plan, its engine and, on the card, the
        engine's CUDA graph) off the clock.

        Serves a short-budget clone of ``req`` through the bucket's engine
        and discards the result, so a timed ``serve`` run measures steady
        state.  Stats are reset afterwards.
        """
        key = self.bucket_key(req)
        eng = self._engine_for(key, req)
        dummy = dataclasses.replace(
            req, request_id="__warmup__", deadline=None,
            max_iters=min(req.max_iters, self.round_iters), min_iters=0,
        )
        slot = eng.free_slots()[0]
        eng.admit(slot, dummy, self.now())
        while eng.busy:
            eng.run_round()
            eng.harvest(self.now())
        eng._slot_used[slot] = False  # not a recycling opportunity
        for k in eng.stats:
            eng.stats[k] = 0
        eng.idle_steps = 0

    # -- intake ------------------------------------------------------------
    def submit(self, req: RecoveryRequest) -> str:
        """Queue one request; returns its bucket key."""
        key = self.bucket_key(req)
        self._queues.setdefault(key, [])
        heapq.heappush(self._queues[key], (-req.priority, self._seq, req))
        self._seq += 1
        return key

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def busy(self) -> bool:
        return any(e.busy for e in self.engines.values())

    # -- the scheduling round ---------------------------------------------
    def _expire_queued(self, key: str, now: float) -> None:
        """Queued requests whose deadline already passed come back as
        flagged zero-iterate results; they never reach a slot."""
        q = self._queues.get(key, [])
        live = []
        for item in q:
            req = item[2]
            if req.deadline is not None and now >= req.deadline:
                self.results.append(RecoveryResult(
                    request_id=req.request_id,
                    x=torch.zeros((req.op.n,), dtype=torch.as_tensor(req.y).dtype),
                    iterations=0,
                    delta=float("inf"),
                    converged=False,
                    deadline_expired=True,
                    arrival_time=req.arrival_time,
                    admitted_time=None,
                    finish_time=now,
                    bucket=key,
                ))
            else:
                live.append(item)
        if len(live) != len(q):
            heapq.heapify(live)
            self._queues[key] = live

    def step(self) -> List[RecoveryResult]:
        """One scheduling round: admit -> iterate -> harvest, every bucket.

        Returns the results harvested this round (also appended to
        ``self.results``).
        """
        now = self.now()
        harvested: List[RecoveryResult] = []
        for key, q in list(self._queues.items()):
            self._expire_queued(key, now)
            q = self._queues[key]
            if not q and key not in self.engines:
                continue
            if q:
                eng = self._engine_for(key, q[0][2])
                for slot in eng.free_slots():
                    if not q:
                        break
                    _, _, req = heapq.heappop(q)
                    eng.admit(slot, req, now)
        for eng in self.engines.values():
            eng.run_round()
            harvested.extend(eng.harvest(self.now()))
        self.results.extend(harvested)
        return harvested

    # -- drivers -----------------------------------------------------------
    def drain(self) -> List[RecoveryResult]:
        """Run scheduling rounds until every queued request is resolved."""
        while self.pending or self.busy:
            self.step()
        return self.results

    def serve(self, requests) -> List[RecoveryResult]:
        """Open-loop serving: each request becomes visible at its
        ``arrival_time`` on the server clock; returns all results once the
        stream is drained."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        i = 0
        while i < len(pending) or self.pending or self.busy:
            now = self.now()
            while i < len(pending) and pending[i].arrival_time <= now:
                self.submit(pending[i])
                i += 1
            if not self.pending and not self.busy and i < len(pending):
                # idle with only future arrivals: wait for the next one
                self.clock.advance_to(pending[i].arrival_time)
                continue
            self.step()
        return self.results

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        per_bucket = {k: dict(e.stats) for k, e in self.engines.items()}
        total = {"admitted": 0, "recycled": 0, "rounds": 0, "slot_iters": 0}
        for s in per_bucket.values():
            for k in total:
                total[k] += s[k]
        return {"buckets": len(self.engines), "total": total,
                "per_bucket": per_bucket}


def summarize(results: List[RecoveryResult]) -> Dict[str, float]:
    """Headline serving metrics: signals/sec over the busy span, latency
    percentiles, convergence/expiry counts."""
    if not results:
        return {"count": 0}
    lat = np.asarray([r.latency for r in results])
    t0 = min(r.arrival_time for r in results)
    t1 = max(r.finish_time for r in results)
    span = max(t1 - t0, 1e-9)
    return {
        "count": len(results),
        "signals_per_sec": len(results) / span,
        "p50_latency_s": float(np.percentile(lat, 50)),
        "p99_latency_s": float(np.percentile(lat, 99)),
        "mean_iterations": float(np.mean([r.iterations for r in results])),
        "converged": sum(r.converged for r in results),
        "expired": sum(r.deadline_expired for r in results),
        "span_s": float(span),
    }
