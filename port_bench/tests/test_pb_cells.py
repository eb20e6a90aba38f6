"""Every cell's whole run at tiny sizes on the CPU: the port agrees with the
plain reference, the bfloat16 control fails, and so does each fault the
cell can have, planted in the timed path: a step that returns its state
unchanged, half of a batch left out, an answer altered where it is
produced.  (No cell spans chips, so no exchange can be left out.)"""

import time
from pathlib import Path

import pytest
import torch

from harness import cell

ROOT = Path(__file__).resolve().parents[2]
DEBLUR = {"cfg": dict(height=16, width=16, frames_per_job=2, iters=30, record_every=10)}
SEC6 = dict(n=256, m=128, k=25, min_iters=10, max_iters=1000)
TINY = {
    "sec7-deblur-1024.l1": DEBLUR,
    "sec7-deblur-1024.nonneg": DEBLUR,
    "sec6-n16384.batch": {"cfg": SEC6, "traffic": dict(signals_per_job=8)},
    "sec6-n16384.stream": {"cfg": SEC6, "traffic": dict(rate_per_s=30, slots=4, round_iters=8,
                                                        check_longest=4, check_sampled=64)},
}
CELLS = sorted(TINY)


def run(workload, seed=2**31 + 5, **kw):
    seconds = 2.0 if workload.endswith(".batch") else 0.6
    out = cell.run_cell(ROOT, workload, seed, seconds, False, torch.device("cpu"),
                        time.perf_counter(), TINY[workload], **kw)
    out.pop("record")
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_fails(workload):
    out = run(workload, use_control=True)
    assert not out["correct"], out["checks"]


def _unchanged_state(monkeypatch):
    from repro_torch.core import admm

    monkeypatch.setattr(admm, "cpadmm_step", lambda op, const, state, p, prox=None: state)


def _half_left_out(monkeypatch):
    from repro_torch.core import solvers
    from repro_torch.serve import engine

    def halved(fn):
        def wrapped(*a, **k):
            x, other = fn(*a, **k)
            x = x.clone()
            x[x.shape[0] // 2:] = 0
            return x, other
        return wrapped

    monkeypatch.setattr(solvers, "solve", halved(solvers.solve))
    monkeypatch.setattr(solvers, "solve_until", halved(solvers.solve_until))
    body = engine.BatchEngine._round_body

    def round_body(self, leave_early):
        body(self, leave_early)
        self._x[self.slots // 2:] = 0

    monkeypatch.setattr(engine.BatchEngine, "_round_body", round_body)


def _answer_altered(monkeypatch):
    import dataclasses

    from repro_torch.core import solvers
    from repro_torch.serve import engine

    def alter(x):
        x = x.clone()
        x[0, 0] += 1e-3 * float(x[0].norm())
        return x

    def altered(fn):
        def wrapped(*a, **k):
            x, other = fn(*a, **k)
            return alter(x), other
        return wrapped

    monkeypatch.setattr(solvers, "solve", altered(solvers.solve))
    monkeypatch.setattr(solvers, "solve_until", altered(solvers.solve_until))
    harvest = engine.BatchEngine.harvest

    def harvest_altered(self, now):
        out = harvest(self, now)
        return [dataclasses.replace(r, x=alter(r.x[None])[0]) if i == 0 else r
                for i, r in enumerate(out)]

    monkeypatch.setattr(engine.BatchEngine, "harvest", harvest_altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_fails(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(workload)
    assert not out["correct"], out["checks"]
