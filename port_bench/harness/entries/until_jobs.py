"""Closed-loop tolerance-driven jobs through ``repro_torch.core.solvers.solve_until``.

The static-wave discipline of ``serve/baseline.py`` without the server: a
job is ``signals_per_job`` signals with per-signal contracts (tolerances
from the configuration's ``tol_mix``, its ``min_iters`` / ``max_iters``),
run until its last signal stops.  Reads from the traffic ``prior``,
``signals_per_job``, ``distinct_jobs``, ``check_among_first`` and, when
traced, ``profile_steps`` / ``host_slice_steps``.
"""

from __future__ import annotations

import time

import torch

from .. import gen as G
from .. import jobs, port, trace, work
from ..record import Answers, Context, Record


def run(ctx: Context) -> Record:
    from repro_torch.core import solvers

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    col, omega = ctx.problem.operator(cfg, G.operator_stream(cfg, dev))
    data = G.stream(ctx.seed, "data", dev)
    batch, distinct = tr["signals_per_job"], tr["distinct_jobs"]
    ys = [G.measure(col, omega, ctx.problem.signals(cfg, data, batch)) for _ in range(distinct)]
    tol_all = G.contract_mix(G.rng(ctx.seed, "contracts"), batch * distinct, cfg["tol_mix"])
    tols = [torch.tensor(tol_all[i * batch:(i + 1) * batch], dtype=torch.float32, device=dev)
            for i in range(distinct)]
    lo, hi = int(cfg["min_iters"]), int(cfg["max_iters"])

    op = port.operator(col, omega)
    pl = port.plan(cfg, op, port.prox(tr["prior"]))
    kw = port.solver_kw(cfg)
    iters, unmet = [], []  # per job: its longest signal's count, signals out of budget

    def until(i, min_iters=lo, max_iters=hi):
        x, age = solvers.solve_until(solvers.RecoveryProblem(op=op, y=ys[i]), cfg["method"],
                                     tol=tols[i], min_iters=min_iters, max_iters=max_iters,
                                     plan=pl, **kw)
        a = age.cpu()
        iters.append(int(a.max()))
        unmet.append(int((a >= max_iters).sum()) + int((~torch.isfinite(x).all(dim=-1)).sum()))
        return x, age

    until(0, min_iters=0, max_iters=2)  # every shape and kernel of a job, off the clock
    setup_s = time.perf_counter() - ctx.t_start

    peak_setup = jobs.peak_bytes(dev)
    jobs.reset_peak(dev)
    iters.clear()
    unmet.clear()
    done, span, kept, lengths = jobs.closed_loop(ctx, until, distinct)
    peak_window = jobs.peak_bytes(dev)

    full = lambda v, t: torch.full((batch,), v, dtype=t, device=dev)
    blocks = [dict(y=ys[i % distinct], x=x, count=age.long(), tol=tols[i % distinct],
                   min=full(lo, torch.int64), max=full(hi, torch.int64))
              for i, (x, age) in kept.items()]
    rec = Record(
        unit=ctx.problem.UNIT, completed=done * batch, span_s=span, attempted=done * batch,
        failed=sum(unmet[:done]), setup_s=setup_s,
        peak_window_bytes=peak_window, peak_run_bytes=max(peak_setup, peak_window),
        answers=Answers(kind="until", col=col, omega=omega, prior=tr["prior"], params=kw,
                        blocks=blocks),
        spans={"job_s": lengths, "iters_per_job": [float(v) for v in iters[:done]]},
    )
    if ctx.trace:
        stepper = solvers.make_stepper(solvers.RecoveryProblem(op=op, y=ys[0]), cfg["method"],
                                       plan=pl, **kw)
        state = [stepper.init()]

        def one_step():
            state[0] = stepper.step(state[0])

        rec.step_device_ms = trace.step_device_ms(one_step)
        rec.least_bytes = work.cpadmm_least_bytes(batch, op.n, op.m)
        k, h = tr["profile_steps"], tr["host_slice_steps"]
        rec.profile = trace.device_profile(lambda: until(0, k, k), lambda: until(0, h, h))
        del state, stepper
    del op, pl
    return rec
