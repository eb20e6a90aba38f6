"""An open-loop stream through ``repro_torch.serve.RecoveryServer.serve``.

Reads from the configuration the solver's parameters and the contracts
(``tol_mix``, ``min_iters``, ``max_iters``); from the traffic
``rate_per_s`` (the offered load: ``rate_per_s * seconds`` requests, their
arrivals spread over the window), ``slots``, ``round_iters``, ``check_longest`` / ``check_sampled`` (the
served results the comparison takes: the longest, and a draw from the
seed among the rest) and, when traced, ``profile_s`` / ``host_slice_s``
(the stream's first seconds served again under the profiler).  Every
request is drawn before the window; the server runs on a wall clock and
drains after the last arrival.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import gen as G
from .. import jobs, port, trace
from ..record import Answers, Context, Record


def run(ctx: Context) -> Record:
    from repro_torch.serve import RecoveryRequest, RecoveryServer, WallClock

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    if tr["prior"] != "l1":
        raise ValueError("the stream entry serves the server's default l1 prior only")
    col, omega = ctx.problem.operator(cfg, G.operator_stream(cfg, dev))
    count = max(1, round(tr["rate_per_s"] * ctx.seconds))
    y = G.measure(col, omega, ctx.problem.signals(cfg, G.stream(ctx.seed, "data", dev), count))
    tols = G.contract_mix(G.rng(ctx.seed, "contracts"), count, cfg["tol_mix"])
    arrive = G.arrival_times(G.rng(ctx.seed, "arrivals"), count, ctx.seconds)
    lo, hi = int(cfg["min_iters"]), int(cfg["max_iters"])

    op = port.operator(col, omega)
    reqs = [RecoveryRequest(request_id=str(i), op=op, y=y[i], tol=float(tols[i]), min_iters=lo,
                            max_iters=hi, arrival_time=float(arrive[i]), method=cfg["method"])
            for i in range(count)]
    kw = port.solver_kw(cfg)
    srv = RecoveryServer(slots=tr["slots"], round_iters=tr["round_iters"], clock=WallClock(),
                         **kw)
    srv.warmup(reqs[0])  # builds the bucket and, on the card, captures its round
    engines = list(srv.engines.values())
    host_ms: list = []
    if ctx.trace:
        for eng in engines:
            eng.timing = True
            eng.run_round = _host_clocked(eng.run_round, host_ms)
    setup_s = time.perf_counter() - ctx.t_start

    peak_setup = jobs.peak_bytes(dev)
    jobs.reset_peak(dev)
    srv.clock = WallClock()
    results = list(srv.serve(reqs))
    peak_window = jobs.peak_bytes(dev)

    ok = [r.converged and not r.deadline_expired for r in results]
    finish = [r.finish_time for r in results]
    rec = Record(
        unit="requests", completed=sum(ok), span_s=max(finish), attempted=count,
        failed=count - sum(ok), setup_s=setup_s,
        peak_window_bytes=peak_window, peak_run_bytes=max(peak_setup, peak_window),
        latencies_s=[r.latency if good else math.inf for r, good in zip(results, ok)],
        queue_waits_s=[r.queue_wait for r in results],
        answers=_answers(ctx, results, reqs, y, col, omega, kw, dev),
        extra=dict(offered=count, done_by_window_end=sum(f <= ctx.seconds for f in finish),
                   rate_per_s=tr["rate_per_s"]),
    )
    if ctx.trace:
        rec.spans["round_host_ms"] = list(host_ms)
        jobs.sync(dev)
        rec.spans["round_device_ms"] = [a.elapsed_time(b) for e in engines
                                        for a, b in e.replay_events]
        rounds = sum(e.stats["rounds"] for e in engines)
        rec.counters = dict(idle_steps=sum(e.idle_steps for e in engines),
                            replayed_steps=rounds * tr["round_iters"] if ctx.cuda else 0)
        for e in engines:
            e.timing = False

        def again(seconds):
            srv.clock = WallClock()
            srv.serve([dataclasses.replace(r, request_id=f"again-{r.request_id}")
                       for r in reqs if r.arrival_time < seconds])

        rec.profile = trace.device_profile(lambda: again(tr["profile_s"]),
                                           lambda: again(tr["host_slice_s"]))
    del srv, engines, reqs, op
    return rec


def _host_clocked(run_round, sink: list):
    """``run_round`` with the host clock around it (to its end, which reads
    the round's age and delta back, so the round has run), in ms."""
    def timed():
        t0 = time.perf_counter()
        run_round()
        sink.append((time.perf_counter() - t0) * 1e3)
    return timed


def _answers(ctx, results, reqs, y, col, omega, kw, dev) -> Answers:
    """The served results the comparison takes: the ``check_longest`` with
    the most iterations, and ``check_sampled`` drawn from the seed among
    the rest."""
    tr = ctx.traffic
    order = sorted(range(len(results)),
                   key=lambda i: (-results[i].iterations, int(results[i].request_id)))
    longest = order[:tr["check_longest"]]
    rest = sorted(order[tr["check_longest"]:], key=lambda i: int(results[i].request_id))
    pick = G.rng(ctx.seed, "sample").choice(len(rest), size=min(len(rest), tr["check_sampled"]),
                                            replace=False)
    chosen = [results[i] for i in longest + [rest[j] for j in sorted(pick)]]
    idx = [int(r.request_id) for r in chosen]
    vec = lambda vals, t: torch.tensor(np.asarray(vals), dtype=t, device=dev)
    block = dict(
        y=y[idx], x=torch.stack([r.x for r in chosen]).to(dev),
        count=vec([r.iterations for r in chosen], torch.int64),
        tol=vec([reqs[i].tol for i in idx], torch.float32),
        min=vec([reqs[i].min_iters for i in idx], torch.int64),
        max=vec([reqs[i].max_iters for i in idx], torch.int64),
    )
    return Answers(kind="until", col=col, omega=omega, prior=tr["prior"], params=kw,
                   blocks=[block], missing=len(reqs) - len(results))
