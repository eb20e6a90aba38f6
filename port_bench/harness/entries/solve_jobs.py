"""Closed-loop fixed-iteration jobs through ``repro_torch.core.solvers.solve``.

Reads from the configuration ``frames_per_job``, ``iters``, ``record_every``,
``method`` and the solver's ``alpha`` / ``rho`` / ``sigma``; from the traffic
``prior``, ``distinct_jobs`` (inputs drawn before the window and cycled)
and ``check_among_first``.  A job is one batched solve of its frames through
the deployment's one operator, ending when its result is on hand.
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
    batch, iters = cfg["frames_per_job"], cfg["iters"]
    ys = [G.measure(col, omega, ctx.problem.signals(cfg, data, batch))
          for _ in range(tr["distinct_jobs"])]

    op = port.operator(col, omega)
    pl = port.plan(cfg, op, port.prox(tr["prior"]))
    kw = port.solver_kw(cfg)

    bad = []  # frames of each job that came back non-finite

    def solve(i, steps=iters, every=cfg["record_every"]):
        x, _ = solvers.solve(solvers.RecoveryProblem(op=op, y=ys[i]), cfg["method"],
                             iters=steps, record_every=every, plan=pl, **kw)
        bad.append(int((~torch.isfinite(x).all(dim=-1)).sum()))  # its sync: the result is here
        return x

    solve(0, steps=2, every=2)  # every shape and kernel of a job, off the clock
    setup_s = time.perf_counter() - ctx.t_start

    peak_setup = jobs.peak_bytes(dev)
    jobs.reset_peak(dev)
    bad.clear()
    done, span, kept, lengths = jobs.closed_loop(ctx, solve, len(ys))
    peak_window = jobs.peak_bytes(dev)

    rec = Record(
        unit=ctx.problem.UNIT, completed=done * batch, span_s=span, attempted=done * batch,
        failed=sum(bad[:done]), setup_s=setup_s,
        peak_window_bytes=peak_window, peak_run_bytes=max(peak_setup, peak_window),
        answers=Answers(kind="fixed", col=col, omega=omega, prior=tr["prior"], params=kw,
                        iters=iters,
                        blocks=[dict(y=ys[i % len(ys)], x=x) for i, x in kept.items()]),
        spans={"job_s": lengths},
    )
    if ctx.trace:
        stepper = solvers.make_stepper(solvers.RecoveryProblem(op=op, y=ys[0]), cfg["method"],
                                       plan=pl, **kw)
        state = [stepper.init()]

        def one_step():
            state[0] = stepper.step(state[0])

        rec.step_device_ms = trace.step_device_ms(one_step)
        rec.least_bytes = work.cpadmm_least_bytes(batch, op.n, op.m)
        rec.profile = trace.device_profile(
            lambda: solve(0), lambda: solve(0, steps=tr["host_slice_iters"],
                                            every=tr["host_slice_iters"]))
        del state, stepper
    del op, pl
    return rec
