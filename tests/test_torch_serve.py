"""The port's recovery server against its own solo solves and the reference's server.

Mirrors the 12 tests of ``tests/test_serve.py`` on the port (``ManualClock``,
seeded streams, n = 128): seeded arrivals, recycled-slot parity with a solo
``solve_until`` (1e-5 relative, equal iteration counts), priority,
deadlines, bucket isolation, the bf16-wire lanes (on a one-rank gloo mesh)
and the hierarchical bucket tags.  Beyond the mirror:

* cross-package parity: the same stream, built by ``repro`` and carried
  across through numpy, served by ``repro.serve.RecoveryServer`` and by the
  port's, both on ``ManualClock``: per request x to 1e-5 relative, equal
  iterations and flags, equal ``stats()`` totals (cpadmm and ista);
* ``tests/dist_progs/serve_prog.py``'s contract on 2 gloo ranks, plus a
  ``WallClock`` deadline run on the mesh that must end with both ranks
  agreeing (rank 0's clock decides);
* ``tune=`` plans a mesh bucket with the autotuner, and a fresh server on
  the same store hits it (one gloo rank);
* on the card (``gpu``; skips here): the engine's captured round against an
  eager ``solve_until``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from repro_torch import interop
from repro_torch.core.circulant import partial_gaussian_circulant
from repro_torch.core.solvers import RecoveryProblem, solve_until
from repro_torch.data.synthetic import paper_regime, sparse_signal
from repro_torch.dist.compat import spawn_fake_devices
from repro_torch.ops.plan import WIRE_ERROR_BOUND, PlanConfig
from repro_torch.serve import (
    ManualClock,
    RecoveryRequest,
    RecoveryServer,
    operator_fingerprint,
    poisson_times,
    static_batch_serve,
    summarize,
    synthetic_workload,
)

N = 128
RHO = 0.01  # the launcher's setting; converges well inside max_iters


def _op(seed=1, n=N, device="cpu"):
    m, _ = paper_regime(n)
    return partial_gaussian_circulant(torch.Generator().manual_seed(seed), n, m,
                                      normalize=True, device=device)


def _server(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("round_iters", 16)
    kw.setdefault("rho", RHO)
    kw.setdefault("sigma", RHO)
    kw.setdefault("clock", ManualClock())
    return RecoveryServer(**kw)


def _workload(op, n_requests, **kw):
    kw.setdefault("rate", 1000.0)
    kw.setdefault("tols", (1e-3, 1e-5))
    kw.setdefault("max_iters", 600)
    return synthetic_workload(op, n_requests, seed=7, **kw)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


def _solo(req, method="cpadmm", **kw):
    x, used = solve_until(RecoveryProblem(op=req.op, y=req.y), method, tol=req.tol,
                          max_iters=req.max_iters, min_iters=req.min_iters, rho=RHO,
                          sigma=RHO, **kw)
    return x, int(used)


# -- determinism -----------------------------------------------------------
def test_poisson_arrivals_deterministic():
    from repro.serve import poisson_times as ref_poisson_times

    a = poisson_times(3, 20, 50.0)
    np.testing.assert_array_equal(a, poisson_times(3, 20, 50.0))
    np.testing.assert_array_equal(a, ref_poisson_times(3, 20, 50.0))  # numpy-seeded, bit-equal
    assert np.all(np.diff(a) > 0) and a[0] > 0
    with pytest.raises(ValueError):
        poisson_times(0, 4, 0.0)


def test_synthetic_workload_reproducible():
    """Bit-for-bit reproducible, and the arrival / tolerance / priority draws
    equal the reference's (the signals are the port's own draws)."""
    from repro.serve import synthetic_workload as ref_workload

    op = _op()
    w1 = _workload(op, 5, priorities=(0, 1, 2))
    w2 = _workload(op, 5, priorities=(0, 1, 2))
    ref = ref_workload(_ref_op(), 5, rate=1000.0, seed=7, tols=(1e-3, 1e-5), max_iters=600,
                       priorities=(0, 1, 2))
    for r1, r2, rr in zip(w1, w2, ref):
        assert r1.request_id == r2.request_id == rr.request_id
        assert r1.tol == r2.tol == rr.tol and r1.arrival_time == r2.arrival_time == rr.arrival_time
        assert r1.priority == rr.priority
        torch.testing.assert_close(r1.y, r2.y, rtol=0, atol=0)


# -- the acceptance pin: recycled slots match run-alone --------------------
def test_recycled_slot_matches_solo_solve():
    """6 requests through 2 slots forces recycling; every result, recycled
    lanes included, matches its solo solve_until run to 1e-5 relative, with
    identical iteration counts."""
    op = _op()
    reqs = _workload(op, 6)
    srv = _server()
    results = srv.serve(reqs)
    assert len(results) == 6
    assert srv.stats()["total"]["recycled"] >= 4  # 6 requests - 2 cold slots
    by_id = {r.request_id: r for r in reqs}
    for res in results:
        x_solo, used = _solo(by_id[res.request_id])
        assert _rel(res.x, x_solo) <= 1e-5, res.request_id
        assert res.iterations == used, res.request_id
        assert res.converged


def test_static_baseline_serves_same_results():
    op = _op()
    reqs = _workload(op, 5)
    cont = _server().serve(reqs)
    stat = static_batch_serve(reqs, slots=2, round_iters=16, rho=RHO, sigma=RHO,
                              clock=ManualClock())
    assert sorted(r.request_id for r in stat) == sorted(r.request_id for r in cont)
    cont_by_id = {r.request_id: r for r in cont}
    for r in stat:
        assert r.iterations == cont_by_id[r.request_id].iterations
        torch.testing.assert_close(r.x, cont_by_id[r.request_id].x, rtol=1e-5, atol=1e-7)


# -- scheduling ------------------------------------------------------------
def test_priority_orders_admission_under_contention():
    """One slot, three same-arrival requests with distinct priorities:
    admission (and hence finish) order is by descending priority."""
    op = _op()
    _, k = paper_regime(N)
    srv = _server(slots=1)
    for pri, rid in ((0, "low"), (2, "high"), (1, "mid")):
        x = sparse_signal(torch.Generator().manual_seed(10 + pri), N, k, device="cpu")
        srv.submit(RecoveryRequest(request_id=rid, op=op, y=op.matvec(x), tol=1e-3,
                                   max_iters=200, priority=pri))
    assert [r.request_id for r in srv.drain()] == ["high", "mid", "low"]


def test_deadline_expiry_returns_flagged_partial():
    """A deadline that lapses mid-solve yields a flagged partial result
    (iterations short of the budget, never an exception); one that lapses
    while queued yields a zero-iterate flagged result."""
    op = _op()
    _, k = paper_regime(N)

    def req(rid, deadline):
        x = sparse_signal(torch.Generator().manual_seed(99), N, k, device="cpu")
        return RecoveryRequest(request_id=rid, op=op, y=op.matvec(x), tol=1e-12,
                               min_iters=50, max_iters=5000, deadline=deadline)

    clock = ManualClock()
    srv = _server(slots=1, clock=clock)
    srv.submit(req("in-slot", deadline=0.5))
    srv.step()  # admitted, one round done, deadline still ahead
    clock.advance_to(1.0)
    results = srv.step()
    assert [r.request_id for r in results] == ["in-slot"]
    r = results[0]
    assert r.deadline_expired and not r.converged
    assert 0 < r.iterations < 5000
    assert bool((r.x != 0).any())  # a partial iterate, not a zero stub

    srv2 = _server(slots=1, clock=ManualClock(t=3.0))
    srv2.submit(req("queued-expired", deadline=1.0))  # already past
    r2 = srv2.drain()[0]
    assert r2.deadline_expired and r2.iterations == 0
    assert r2.admitted_time is None
    assert not bool(r2.x.any())


# -- bucket isolation ------------------------------------------------------
def test_distinct_operators_never_share_a_batch():
    """Same shapes, different spectra: the fingerprints differ, so the
    requests land in separate engines and each recovers against its own
    operator (solo parity per result)."""
    op_a, op_b = _op(seed=1), _op(seed=2)
    assert operator_fingerprint(op_a) != operator_fingerprint(op_b)
    reqs = []
    for tag, op in (("a", op_a), ("b", op_b)):
        for r in _workload(op, 2):
            reqs.append(dataclasses.replace(r, request_id=f"{tag}-{r.request_id}"))
    srv = _server()
    results = srv.serve(reqs)
    assert srv.stats()["buckets"] == 2
    by_id = {r.request_id: r for r in reqs}
    for res in results:
        assert _rel(res.x, _solo(by_id[res.request_id])[0]) <= 1e-5, res.request_id


def test_plan_config_splits_buckets():
    """rfft and full-complex plan configs never share a batch: the bucket
    key embeds PlanConfig.describe()."""
    op = _op()
    base = _workload(op, 1)[0]
    r_full = dataclasses.replace(base, plan_config=PlanConfig())
    r_rfft = dataclasses.replace(base, plan_config=PlanConfig(rfft=True, n1=8, n2=16))
    srv = _server()
    assert srv.bucket_key(r_full) != srv.bucket_key(r_rfft)
    # methods split buckets too
    assert srv.bucket_key(base) != srv.bucket_key(dataclasses.replace(base, method="ista"))


# -- metrics ---------------------------------------------------------------
def test_summarize_reports_throughput_and_percentiles():
    op = _op()
    s = summarize(_server().serve(_workload(op, 4)))
    assert s["count"] == 4 and s["converged"] == 4 and s["expired"] == 0
    assert s["signals_per_sec"] > 0
    assert 0 <= s["p50_latency_s"] <= s["p99_latency_s"]
    assert summarize([]) == {"count": 0}


def test_wire_dtype_splits_buckets():
    """bf16-wire and fp32-wire requests never share a lane."""
    op = _op()
    base = _workload(op, 1)[0]
    srv = _server()
    k32 = srv.bucket_key(dataclasses.replace(base, plan_config=PlanConfig(rfft=True, n1=8, n2=16)))
    k16 = srv.bucket_key(dataclasses.replace(
        base, plan_config=PlanConfig(rfft=True, n1=8, n2=16, wire_dtype="bf16")))
    assert k32 != k16
    assert "wire=bf16" in k16 and "wire=" not in k32


def test_recycled_slots_with_bf16_wire_bucket_isolated():
    """A mixed fp32 / bf16-wire stream on a one-rank gloo mesh splits into two
    engines with recycling inside each.  The fp32 lane keeps the 1e-5
    recycled-slot parity (and the iteration counts) with its solo same-plan
    solve; the bf16 lane stays within twice the wire bound of its solo
    solve, and of the fp32 answer."""
    out = spawn_fake_devices(1, progs.serve_wire_program, 8, 16, RHO)[0]
    stats = out["stats"]
    assert len(out["results"]) == 6 and stats["buckets"] == 2
    assert all(s["recycled"] >= 1 for s in stats["per_bucket"].values())
    assert out["wires"] == {"w32": "fp32", "w16": "bf16"}  # the guard kept the bf16 wire
    for rid, res in out["results"].items():
        solo = out["solo"][rid]
        rel = _rel(res["x"], solo["x"])
        if rid.startswith("w32"):
            assert rel <= 1e-5, (rid, rel)
            assert res["iterations"] == solo["iterations"], rid
        else:
            assert rel <= 2 * WIRE_ERROR_BOUND, (rid, rel)
            x32 = out["results"]["w32" + rid[3:]]["x"]
            assert 0 < _rel(res["x"], x32) <= 2 * WIRE_ERROR_BOUND, rid
        assert res["converged"], rid


def test_hier_plan_splits_buckets():
    """Hierarchical and flat plans never share a serve lane: the bucket key
    carries describe()'s hier= / inter_wire= tags; four configs on one
    operator give four buckets."""
    op = _op()
    base = _workload(op, 1)[0]
    flat = PlanConfig(rfft=True, n1=8, n2=16)
    tflat = PlanConfig(rfft=True, n1=8, n2=16, axis_name=("host", "device"))
    hier = PlanConfig(rfft=True, n1=8, n2=16, axis_name=("host", "device"), hier_axes=(2, 4))
    hier16 = PlanConfig(rfft=True, n1=8, n2=16, axis_name=("host", "device"), hier_axes=(2, 4),
                        inter_wire_dtype="bf16")
    srv = _server()
    keys = [srv.bucket_key(dataclasses.replace(base, plan_config=c))
            for c in (flat, tflat, hier, hier16)]
    assert len(set(keys)) == 4, keys
    assert "hier=2x4" in keys[2] and "inter_wire=bf16" in keys[3]
    assert "hier=" not in keys[0] and "hier=flat" in keys[1]


# -- the port against the reference's server -------------------------------
def _ref_op(seed=1, n=N):
    import jax

    from repro.core import partial_gaussian_circulant as ref_circulant

    m, _ = paper_regime(n)
    return ref_circulant(jax.random.PRNGKey(seed), n, m, normalize=True)


@pytest.mark.parametrize("method", ["cpadmm", "ista"])
def test_server_matches_the_reference_server(method):
    """One stream, built by the reference and carried across through numpy,
    served by both packages' servers on ManualClock."""
    from repro.serve import ManualClock as RefClock
    from repro.serve import RecoveryServer as RefServer
    from repro.serve import synthetic_workload as ref_workload

    ref_op = _ref_op()
    ref_reqs = ref_workload(ref_op, 6, rate=1000.0, seed=7, tols=(1e-3, 1e-5), max_iters=600,
                            method=method)
    ref_srv = RefServer(slots=2, round_iters=16, rho=RHO, sigma=RHO, clock=RefClock())
    ref_results = {r.request_id: r for r in ref_srv.serve(ref_reqs)}

    a = np.asarray
    op = interop.partial_circulant_from_numpy(a(ref_op.circ.col), a(ref_op.circ.spec),
                                              a(ref_op.omega), device="cpu")
    reqs = [RecoveryRequest(request_id=r.request_id, op=op, y=torch.from_numpy(np.array(r.y)),
                            tol=r.tol, min_iters=r.min_iters, max_iters=r.max_iters,
                            priority=r.priority, deadline=r.deadline,
                            arrival_time=r.arrival_time, method=method)
            for r in ref_reqs]  # np.array copies: the reference's arrays are read-only
    srv = _server()
    results = srv.serve(reqs)
    assert sorted(r.request_id for r in results) == sorted(ref_results)
    for res in results:
        want = ref_results[res.request_id]
        assert _rel(res.x, want.x) <= 1e-5, res.request_id
        assert (res.iterations, res.converged, res.deadline_expired) == \
            (want.iterations, want.converged, want.deadline_expired), res.request_id
    assert srv.stats()["total"] == ref_srv.stats()["total"]


# -- on a mesh -------------------------------------------------------------
def test_mesh_server_on_two_gloo_ranks():
    """``serve_prog.py``'s contract on 2 ranks: rfft and full-complex
    buckets never mix, every result (recycled lanes too) matches its solo
    local solve to 1e-5, and a WallClock deadline run ends with both ranks
    holding the same results."""
    n1 = n2 = 16
    ranks = spawn_fake_devices(2, progs.serve_mesh_program, n1, n2, RHO)
    out = ranks[0]
    assert out["stats"]["buckets"] == 2 and out["stats"]["total"]["recycled"] >= 2
    op = progs._serve_op(n1, n2)
    reqs = {r.request_id: r for r in synthetic_workload(op, 6, rate=1000.0, seed=5,
                                                        tols=(1e-3, 1e-5), max_iters=400)}
    assert sorted(out["results"]) == sorted(reqs)
    for rid, res in out["results"].items():
        x_solo, used = _solo(reqs[rid])
        assert _rel(res["x"], x_solo) <= 1e-5, rid
        assert res["iterations"] == used, rid
        assert res["converged"] or res["iterations"] == reqs[rid].max_iters, rid
    buckets = {res["bucket"].split("|")[-1] for res in out["results"].values()}
    assert len(buckets) == 2
    wall = [{rid: (r["iterations"], r["expired"], r["converged"]) for rid, r in rk["wall"].items()}
            for rk in ranks]
    assert wall[0] == wall[1] and len(wall[0]) == 4
    assert all(expired and not conv for _, expired, conv in wall[0].values())


def test_tune_names_the_tuner_item(tmp_path):
    """``tune=`` runs (it raised before the tuner was ported): a mesh bucket
    is planned by the autotuner, a fresh server on the same store hits it,
    and both serve every request alike (one gloo rank)."""
    RecoveryServer(tune="model")  # a local server takes it and plans untuned
    out = spawn_fake_devices(1, progs.serve_tune_program, 16, 16,
                             str(tmp_path / "plan_cache.json"))[0]
    cold, warm = out["cold"], out["warm"]
    assert cold["counters"]["cache_misses"] == 1 and cold["counters"]["scored"] > 0
    assert warm["counters"] == {"scored": 0, "measured": 0, "cache_hits": 1, "cache_misses": 0}
    assert len(cold["plans"]) == 1 and warm["plans"] == cold["plans"]
    assert warm["iterations"] == cold["iterations"] and all(cold["converged"])
    assert out["static"] == 0


# -- on the card ------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures its round only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("method,n", [("cpadmm", 16384), ("ista", 4096)])
def test_captured_round_matches_eager_solve_until_on_card(method, n, cuda_device):
    """The engine's captured round, recycling 6 requests through 2 slots, on
    the kernel steps: each result against an eager solo solve_until."""
    from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
    from repro_torch.kernels.soft_threshold.ops import fused_ista_update

    op = _op(n=n, device=cuda_device)
    reqs = synthetic_workload(op, 6, rate=1000.0, seed=7, tols=(1e-3, 1e-5), max_iters=600,
                              method=method)
    srv = _server(round_iters=32)
    before = (fused_cpadmm_tail.launches, fused_ista_update.launches)
    results = srv.serve(reqs)
    eng = next(iter(srv.engines.values()))
    assert eng.graphed and srv.stats()["total"]["recycled"] >= 4
    after = (fused_cpadmm_tail.launches, fused_ista_update.launches)
    assert after[0 if method == "cpadmm" else 1] > before[0 if method == "cpadmm" else 1]
    by_id = {r.request_id: r for r in reqs}
    for res in results:
        x_solo, used = _solo(by_id[res.request_id], method)
        assert _rel(res.x, x_solo.cpu()) <= 1e-4, res.request_id
        assert res.iterations == used, res.request_id
