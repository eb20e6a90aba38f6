"""Programs the port's tests run on spawned gloo ranks (``spawn_fake_devices``).

Kept apart from the test files and free of JAX: each rank imports the
module that defines the function it runs, and these need torch and
``repro_torch`` alone.  Every rank builds the same problem from the same
numpy arrays or seeds; rank 0 returns the results, the others ``None``.
"""

import torch

from repro_torch import interop
from repro_torch.core.compression import compressed_mean, compression_wire_bytes, make_compressor
from repro_torch.core.mapmaking import build_mapmaking_plan, solve_mapmaking
from repro_torch.core.solvers import RecoveryProblem, solve
from repro_torch.dist.compat import make_mesh
from repro_torch.ops.plan import PlanConfig, plan


def _lead(out):
    return out if torch.distributed.get_rank() == 0 else None


def prox_mesh_program(a, shape, priors, kw, iters=30):
    """Each prior's CPADMM and ISTA solve on one mesh beside the local solve,
    and TV's hybrid step asked for unfused."""
    names = ("model",) if len(shape) == 1 else ("data", "model")
    mesh = make_mesh(shape, names)
    op = interop.partial_circulant_from_numpy(a["col"], a["spec"], a["omega"], device="cpu")
    prob = RecoveryProblem(op=op, y=torch.from_numpy(a["y"]),
                           x_true=torch.from_numpy(a["x_true"]))
    batch_axis = None if len(shape) == 1 else "data"
    out = {}
    for name, prox in priors.items():
        for method in ("cpadmm", "ista"):
            pl = plan(op, mesh, batch_axis=batch_axis, prox=prox)
            x, _ = solve(prob, method, iters=iters, plan=pl, **kw)
            out[name, method] = pl.gather_batch(x)
            out[name, method, "local"] = solve(prob, method, iters=iters, record_every=iters,
                                               plan=plan(op, prox=prox), **kw)[0]
    pl = plan(op, mesh, batch_axis=batch_axis, prox=priors["tv"], fused=False)
    out["tv", "unfused"] = pl.gather_batch(solve(prob, "cpadmm", iters=iters, plan=pl, **kw)[0])
    return _lead(out)


def mapmaking_mesh_program(a, iters):
    """The TV map-making solve on a 2-rank model axis (rfft)."""
    mesh = make_mesh((2,), ("model",))
    problem = interop.mapmaking_problem_from_numpy(**a, device="cpu")
    pl = build_mapmaking_plan(problem, mesh, rfft=True)
    z, m = solve_mapmaking(problem, plan=pl, iters=iters, alpha=1e-4)
    return _lead((z, m["psnr_db"], pl.config.describe()))


def compression_program(ranks, dim, ratio, steps=30):
    """``tests/dist_progs/compression_prog.py`` on a gloo 'data' axis: every
    rank builds the operator from seed 7 and holds its own sparse gradient
    (a shared support, its own values); one compressed mean, then ``steps``
    with error feedback.  Every rank returns its last output."""
    gen = lambda seed: torch.Generator().manual_seed(seed)
    mesh = make_mesh((ranks,), ("data",))
    rank = torch.distributed.get_rank()
    spec, state0 = make_compressor(gen(7), dim, ratio=ratio, decode_iters=50, alpha=3e-3,
                                   device="cpu")
    k = dim // 64
    support = torch.randperm(dim, generator=gen(0))[:k]
    g_all = torch.zeros(ranks, dim)
    g_all[:, support] = torch.randn(ranks, k, generator=gen(1))
    g_mean = g_all.mean(dim=0)

    out, _ = compressed_mean(spec, state0, g_all[rank], mesh, "data")
    err = float((out - g_mean).norm() / g_mean.norm())
    accum, state = torch.zeros(dim), state0
    for _ in range(steps):
        out, state = compressed_mean(spec, state, g_all[rank], mesh, "data")
        accum += out
    err_avg = float((accum / steps - g_mean).norm() / g_mean.norm())
    return dict(err=err, err_avg=err_avg, out=out, wire=compression_wire_bytes(spec))


def _serve_op(n1, n2, seed=1):
    """The serving programs' operator: partial Gaussian, m = n/2, CPU."""
    from repro_torch.core.circulant import partial_gaussian_circulant

    n = n1 * n2
    return partial_gaussian_circulant(torch.Generator().manual_seed(seed), n, n // 2,
                                      normalize=True, device="cpu")


def _served(results):
    return {r.request_id: dict(x=r.x, iterations=r.iterations, converged=r.converged,
                               expired=r.deadline_expired, bucket=r.bucket)
            for r in results}


def serve_mesh_program(n1, n2, rho):
    """``tests/dist_progs/serve_prog.py`` on a gloo model axis: 6 requests,
    half pinning the rfft plan and half the full-complex one, through 2
    slots a bucket on ``ManualClock``; then a ``WallClock`` run whose
    deadlines lapse mid-solve.  Every rank returns its results."""
    import dataclasses

    from repro_torch.serve import ManualClock, RecoveryServer, WallClock, synthetic_workload

    mesh = make_mesh((torch.distributed.get_world_size(),), ("model",))
    op = _serve_op(n1, n2)
    cfg = {True: PlanConfig(rfft=True, n1=n1, n2=n2), False: PlanConfig(rfft=False, n1=n1, n2=n2)}
    base = synthetic_workload(op, 6, rate=1000.0, seed=5, tols=(1e-3, 1e-5), max_iters=400)
    reqs = [dataclasses.replace(r, plan_config=cfg[bool(i % 2)]) for i, r in enumerate(base)]
    srv = RecoveryServer(mesh=mesh, slots=2, round_iters=32, rho=rho, sigma=rho,
                         clock=ManualClock())
    out = dict(results=_served(srv.serve(reqs)), stats=srv.stats())
    # a wall clock: each rank's own differs, rank 0's decides; the deadlines
    # lapse while the lanes are still far from their (unreachable) tolerance
    late = synthetic_workload(op, 4, rate=1000.0, seed=6, tols=(1e-12,), max_iters=100000,
                              deadline_slack=0.5)
    wall = RecoveryServer(mesh=mesh, slots=2, round_iters=8, rho=rho, sigma=rho,
                          clock=WallClock())
    out["wall"] = _served(wall.serve(late))
    return out


def serve_wire_program(n1, n2, rho):
    """``tests/test_serve.py``'s bf16-wire case on a gloo mesh: a mixed
    fp32 / bf16-wire stream in two buckets, each result beside its solo
    ``solve_until`` under the same plan (rank 0 returns)."""
    import dataclasses

    from repro_torch.core.solvers import solve_until
    from repro_torch.serve import ManualClock, RecoveryServer, synthetic_workload

    mesh = make_mesh((torch.distributed.get_world_size(),), ("model",))
    op = _serve_op(n1, n2)
    cfgs = {"w32": PlanConfig(rfft=True, n1=n1, n2=n2),
            "w16": PlanConfig(rfft=True, n1=n1, n2=n2, wire_dtype="bf16")}
    reqs = []
    for tag, cfg in cfgs.items():
        for r in synthetic_workload(op, 3, rate=1000.0, seed=7, tols=(1e-3,), max_iters=600):
            reqs.append(dataclasses.replace(r, request_id=f"{tag}-{r.request_id}",
                                            plan_config=cfg))
    srv = RecoveryServer(mesh=mesh, slots=2, round_iters=16, rho=rho, sigma=rho,
                         clock=ManualClock())
    results = _served(srv.serve(reqs))
    plans = {tag: plan(op, mesh, rfft=True, n1=n1, n2=n2, wire_dtype=cfg.wire_dtype)
             for tag, cfg in cfgs.items()}
    solo = {}
    for req in reqs:
        x, used = solve_until(RecoveryProblem(op=op, y=req.y), "cpadmm", tol=req.tol,
                              max_iters=req.max_iters, min_iters=req.min_iters, rho=rho,
                              sigma=rho, plan=plans[req.request_id.split("-")[0]])
        solo[req.request_id] = dict(x=x, iterations=int(used))
    return _lead(dict(results=results, solo=solo, stats=srv.stats(),
                      wires={t: p.wire_dtype for t, p in plans.items()}))


def hier_program(shape, iters):
    """``tests/dist_progs/hier_prog.py`` on gloo ranks, a ``(data, host,
    device)`` mesh: the hierarchical exchange against the flat one (on the
    same factored mesh and on a plain ``(data, model)`` mesh) for matvec,
    rmatvec and every overlap K; each tier's bytes for one matvec; CPADMM
    solves with fp32 hops, bf16 hops and bf16 on both tiers."""
    from repro_torch.data.synthetic import sparse_signal
    from repro_torch.dist import fft as D
    from repro_torch.dist.compat import make_hier_mesh

    data, H, Dv = shape
    n1, n2 = 32, 32
    n = n1 * n2
    mesh = make_hier_mesh(data, H, Dv)
    flat_mesh = make_mesh((data, H * Dv), ("data", "model"))
    op = _serve_op(n1, n2)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(n, generator=gen)
    x_true = sparse_signal(torch.Generator().manual_seed(0), n, n // 10, device="cpu")
    yfull = op.project_back(op.matvec(x_true))
    prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)
    out = {}
    for rfft in (False, True):
        for K in (1, 2, 4):
            kw = dict(n1=n1, n2=n2, rfft=rfft, overlap=K)
            single = plan(op, flat_mesh, **kw)
            flat = plan(op, mesh, axis_name=("host", "device"), **kw)
            hier = plan(op, mesh, hier_axes=(H, Dv), **kw)
            ref = single.matvec(x)
            out[rfft, K] = dict(
                flat=bool(torch.equal(flat.matvec(x), ref)),
                hier=bool(torch.equal(hier.matvec(x), ref)),
                rmatvec=bool(torch.equal(hier.rmatvec(yfull), single.rmatvec(yfull))),
                describe=hier.config.describe(), axis_name=hier.axis_name)
            if K == 1:
                for name, pl in (("flat", flat), ("hier", hier)):
                    D.reset_wire_bytes()
                    pl.matvec(x)
                    out[rfft, "bytes", name] = dict(D.WIRE_BYTES)
    base = dict(n1=n1, n2=n2, rfft=True, overlap=2)
    kw = dict(iters=iters, record_every=iters, alpha=1e-4, rho=0.01, sigma=0.01)
    solves = {
        "flat": plan(op, mesh, axis_name=("host", "device"), **base),
        "hier": plan(op, mesh, hier_axes=(H, Dv), **base),
        "inter16": plan(op, mesh, hier_axes=(H, Dv), inter_wire_dtype="bf16", **base),
        "both16": plan(op, mesh, hier_axes=(H, Dv), wire_dtype="bf16",
                       inter_wire_dtype="bf16", **base),
    }
    for name, pl in solves.items():
        out["solve", name] = solve(prob, "cpadmm", plan=pl, **kw)[0]
        out["wires", name] = (pl.wire_dtype, pl.inter_wire_dtype)
    for name in ("hier", "inter16"):
        D.reset_wire_bytes()
        solves[name].matvec(x)
        out["bytes", name] = dict(D.WIRE_BYTES)
    return _lead(out)


def hier_degenerate_program(x, factorizations, n1, n2):
    """``tests/test_dist_equiv.py``'s and ``tests/test_plan.py``'s
    hierarchical cases on one gloo rank: the (1, 1, 1) (data, host, device)
    mesh runs the whole two-stage code path (device-major ranks, the pair's
    index, the reorder) with no inter-host hop.  -> the flat and the
    hierarchical transforms of ``x`` cut to each factorization, every
    overlap K, a batch of 3 on the data axis, both matvecs, the plan
    layer's refusals on a mesh, and a CPADMM solve on each plan."""
    from repro_torch.dist import fft as D
    from repro_torch.dist.compat import make_hier_mesh

    hier = make_hier_mesh(1, 1, 1)
    flat = make_mesh((1,), ("model",))
    flat2 = make_mesh((1, 1), ("data", "model"))
    pair = ("host", "device")
    x = torch.from_numpy(x)
    out = {}
    for f1, f2 in factorizations:
        a = D.layout_2d(x[:f1 * f2], f1, f2)
        for K in (1, 2, 3):
            f, i = D.make_distributed_fft(flat, overlap=K)
            fh, ih = D.make_distributed_fft(hier, axis_name=pair, overlap=K, hier=True)
            r, ir = D.make_distributed_rfft(flat, f2, overlap=K)
            rh, irh = D.make_distributed_rfft(hier, f2, axis_name=pair, overlap=K, hier=True)
            ac = a.to(torch.complex64)
            out[f1, f2, K] = dict(fft=(fh(ac), f(ac)), ifft=(ih(fh(ac)), i(f(ac))),
                                  rfft=(rh(a), r(a)), irfft=(irh(rh(a)), ir(r(a))))
    for f1, f2 in ((32, 16), (15, 16)):
        xb = D.layout_2d(torch.stack([x[:f1 * f2], -x[:f1 * f2], 2 * x[:f1 * f2]]), f1, f2)
        r, ir = D.make_distributed_rfft(flat2, f2, overlap=2)
        rh, irh = D.make_distributed_rfft(hier, f2, axis_name=pair, overlap=2, hier=True)
        out["batch", f1, f2] = dict(rfft=(rh(xb), r(xb)), irfft=(irh(rh(xb)), ir(r(xb))))
    op = _serve_op(n1, n2)
    a = D.layout_2d(x[:n1 * n2], n1, n2)
    col = D.layout_2d(op.circ.col, n1, n2)
    for rfft in (False, True):
        spec = (D.make_distributed_rfft(flat, n2)[0](col) if rfft
                else D.make_distributed_fft(flat)[0](col.to(torch.complex64)))
        mv = D.make_distributed_matvec(flat, rfft=rfft)
        mvh = D.make_distributed_matvec(hier, axis_name=pair, rfft=rfft, hier=True)
        out["matvec", rfft] = [(mvh(spec, a, t), mv(spec, a, t)) for t in (False, True)]

    def refusal(**kw):
        try:
            plan(op, kw.pop("mesh"), n1=n1, n2=n2, **kw)
        except ValueError as e:
            return str(e)
        return None

    out["refusals"] = dict(
        inter_wire=refusal(mesh=flat, inter_wire_dtype="bf16"),
        extents=refusal(mesh=hier, hier_axes=(2, 2)),
        no_pair=refusal(mesh=flat, hier_axes=(1, 1)),
    )
    from repro_torch.data.synthetic import sparse_signal

    x_true = sparse_signal(torch.Generator().manual_seed(0), n1 * n2, n1 * n2 // 10,
                           device="cpu")
    prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)
    kw = dict(iters=40, record_every=40, alpha=1e-4, rho=0.01, sigma=0.01)
    pf = plan(op, flat, n1=n1, n2=n2, rfft=True)
    ph = plan(op, hier, n1=n1, n2=n2, rfft=True, hier_axes=(1, 1))
    out["solve"] = dict(hier=ph.hier, axis_name=ph.axis_name,
                        x=(solve(prob, "cpadmm", plan=ph, **kw)[0],
                           solve(prob, "cpadmm", plan=pf, **kw)[0]))
    return out


# -- the plan autotuner (repro_torch.ops.tune) --------------------------------
def _tune_store(path):
    """A plan store on ``path`` that counts its writes on this rank."""
    from repro_torch.ops import tune

    class CountingCache(tune.PlanCache):
        puts = 0

        def put(self, key, entry):
            type(self).puts += 1
            super().put(key, entry)

    return CountingCache(path)


def _ref_problem(a):
    op = interop.partial_circulant_from_numpy(a["col"], a["spec"], a["omega"], device="cpu")
    return op, RecoveryProblem(op=op, y=torch.from_numpy(a["y"]),
                               x_true=torch.from_numpy(a["x_true"]))


def tune_one_rank_program(a, store, kw, iters):
    """``tests/test_tune.py``'s cases that walk or time a block, on a
    one-rank model axis: each case's counters and picks, and a measure-tuned
    plan's solve beside the untuned plan's."""
    from repro_torch.core.circulant import partial_gaussian_circulant
    from repro_torch.ops import tune

    mesh = make_mesh((1,), ("model",))
    op, prob = _ref_problem(a)
    n1, n2 = a["n1n2"]
    cache = tune.PlanCache(store)
    out = {}

    def case(name, fn):
        tune.reset_counters()
        out[name] = fn()
        out[name + "/counters"] = dict(tune.COUNTERS)

    # a warm store: the same config with no scoring
    case("cold", lambda: tune.tuned_config(op, mesh, batch=2, cache=cache))
    case("warm", lambda: tune.tuned_config(op, mesh, batch=2, cache=cache))
    # a model entry does not serve a measure request; a measure entry serves both
    model_cache = tune.PlanCache(store + ".modes")
    case("model", lambda: tune.tuned_config(op, mesh, mode="model", batch=2, cache=model_cache))
    case("measure", lambda: tune.tuned_config(op, mesh, mode="measure", batch=2,
                                              cache=model_cache))
    case("both", lambda: (tune.tuned_config(op, mesh, mode="model", batch=2, cache=model_cache),
                          tune.tuned_config(op, mesh, mode="measure", batch=2,
                                            cache=model_cache)))
    case("pinned", lambda: tune.tuned_config(op, mesh, batch=2, pins={"rfft": False},
                                             cache=tune.PlanCache(store + ".pinned")))
    # the model's ranking on walked blocks
    side = 1024  # the paper's Sec. 7 frame, n = 2^20: a few tenths of a second a walk here
    big = partial_gaussian_circulant(torch.Generator().manual_seed(1), side * side,
                                     side * side // 2, normalize=True, device="cpu")
    case("rfft", lambda: [(s, c.rfft) for s, c, _ in tune.score_candidates(
        big, mesh, [PlanConfig(rfft=False, n1=side, n2=side),
                    PlanConfig(rfft=True, n1=side, n2=side)], batch=1, iters=2)])
    case("overlap", lambda: [(s, c.overlap) for s, c, _ in tune.score_candidates(
        op, mesh, [PlanConfig(rfft=True, overlap=K, n1=n1, n2=n2) for K in (1, 2, 4, 8)],
        batch=1, iters=2)])
    case("wire", lambda: [(s, c.wire_dtype) for s, c, _ in tune.score_candidates(
        op, mesh, [PlanConfig(rfft=True, n1=n1, n2=n2, wire_dtype=w) for w in ("bf16", "fp32")],
        batch=1, iters=2)])
    # a measure-tuned plan solves as the untuned plan does; its warm rebuild
    tuned_cache = tune.PlanCache(store + ".measure")
    tune.reset_counters()
    pl = plan(op, mesh, tune="measure", batch=2, tune_opts={"cache": tuned_cache})
    out["measured"] = tune.COUNTERS["measured"]
    out["tuned/x"] = solve(prob, "cpadmm", iters=iters, record_every=iters, plan=pl, **kw)[0]
    out["untuned/x"] = solve(prob, "cpadmm", iters=iters, record_every=iters,
                             plan=plan(op, mesh), **kw)[0]
    out["tuned/wire"] = pl.wire_dtype
    out["tuned/config"] = pl.config
    out["rebuilt/config"] = plan(op, mesh, tune="measure", batch=2,
                                 tune_opts={"cache": tuned_cache}).config
    return out


def tune_autotune_program(a, store, kw, iters):
    """``tests/dist_progs/autotune_prog.py`` on a gloo model axis: the
    model-tuned plan's solve beside the untuned plan's, the same under an
    fp32 wire pin, the all-to-all bytes of an rfft and a full-complex
    matvec, and a warm store.  Every rank returns its configs and the
    store writes it made; rank 0 also the solves."""
    from repro_torch.dist import fft as D
    from repro_torch.ops import tune

    p = torch.distributed.get_world_size()
    mesh = make_mesh((p,), ("model",))
    op, prob = _ref_problem(a)
    n1, n2 = a["n1n2"]
    cache = _tune_store(store)
    tune.reset_counters()
    tuned = plan(op, mesh, tune=True, tune_opts={"cache": cache})
    cold = dict(tune.COUNTERS)
    solve_kw = dict(iters=iters, record_every=iters, **kw)
    out = dict(tuned=tuned.config, cold=cold)
    out["x/default"] = solve(prob, "cpadmm", plan=plan(op, mesh, n1=n1, n2=n2), **solve_kw)[0]
    out["x/tuned"] = solve(prob, "cpadmm", plan=tuned, **solve_kw)[0]
    pinned = plan(op, mesh, tune=True, wire_dtype="fp32", tune_opts={"cache": cache})
    out["pinned"] = pinned.config
    out["x/pinned"] = solve(prob, "cpadmm", plan=pinned, **solve_kw)[0]
    x = torch.randn(n1 * n2, generator=torch.Generator().manual_seed(3))
    for rfft in (False, True):
        pl = plan(op, mesh, n1=n1, n2=n2, rfft=rfft)
        D.reset_wire_bytes()
        pl.matvec(x)
        out[f"a2a/{rfft}"] = D.WIRE_BYTES["flat"]
    tune.reset_counters()
    out["warm"] = plan(op, mesh, tune=True, tune_opts={"cache": cache}).config
    out["warm/counters"] = dict(tune.COUNTERS)
    out["puts"] = type(cache).puts
    if torch.distributed.get_rank():
        out = {k: v for k, v in out.items() if not k.startswith("x/")}
    return out


def tune_hier_program(n1, n2, batch, store, score_iters):
    """``tests/dist_progs/hier_prog.py``'s tuner case on a (2, 2, 2) (data,
    host, device) mesh: the cost model picks the hierarchical exchange with
    nothing but the factorization, rfft and fused pinned; every rank
    returns its pick."""
    from repro_torch.dist.compat import make_hier_mesh
    from repro_torch.ops import tune

    mesh = make_hier_mesh(2, 2, 2)
    return tune.tuned_config(_serve_op(n1, n2), mesh, batch=batch, score_iters=score_iters,
                             cache=tune.PlanCache(store),
                             pins={"n1": n1, "n2": n2, "rfft": True, "fused": True})


def shim_program(a, kw, iters):
    """``tests/test_plan.py``'s shim case on one gloo rank: the deprecated
    ``make_dist_cpadmm`` against the plan route it wraps."""
    import warnings

    from repro_torch.dist.fft import layout_2d, unlayout_2d
    from repro_torch.dist.recovery import make_dist_cpadmm

    mesh = make_mesh((1,), ("model",))
    op, prob = _ref_problem(a)
    n1, n2 = a["n1n2"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solver = make_dist_cpadmm(mesh, n1, n2, iters, fused=True, rfft=True)
    pl = plan(op, mesh, n1=n1, n2=n2, rfft=True)
    z_shim = solver(pl.spec2d, pl.mask2d, layout_2d(op.project_back(prob.y), n1, n2),
                    kw["alpha"], kw["rho"], kw["sigma"])
    z_plan = solve(prob, "cpadmm", iters=iters, record_every=iters, plan=pl, **kw)[0]
    return dict(shim=unlayout_2d(z_shim), plan=z_plan,
                warned=[(w.category.__name__, str(w.message)) for w in caught])


def serve_tune_program(n1, n2, store):
    """``RecoveryServer(tune=...)`` on a gloo model axis, twice on one
    store: the first server tunes its mesh bucket, a fresh one finds the
    stored plan.  Every rank returns its bucket plans and counters."""
    import os

    from repro_torch.ops import tune
    from repro_torch.serve import (
        ManualClock,
        RecoveryServer,
        static_batch_serve,
        synthetic_workload,
    )

    os.environ["REPRO_TORCH_PLAN_CACHE"] = store
    mesh = make_mesh((torch.distributed.get_world_size(),), ("model",))
    op = _serve_op(n1, n2)
    reqs = synthetic_workload(op, 4, rate=1000.0, seed=5, tols=(1e-3,), max_iters=200)
    out = {}
    for run in ("cold", "warm"):
        tune.reset_counters()
        srv = RecoveryServer(mesh=mesh, slots=2, round_iters=16, rho=0.01, sigma=0.01,
                             tune="model", clock=ManualClock())
        results = srv.serve(reqs)
        out[run] = dict(plans=[e.plan.config for e in srv.engines.values()],
                        counters=dict(tune.COUNTERS), converged=[r.converged for r in results],
                        iterations=[r.iterations for r in results])
    out["static"] = len(static_batch_serve([], mesh=mesh, tune=True))
    return out


def kernel_walk_program(side, frames):
    """On one gloo rank holding its blocks on the card: walk a kernel-tail
    block (fp32 and bf16 wires) and hold the kernels the walk heard against
    the wrappers' own launch counters over the same call."""
    from repro_torch.core.circulant import partial_gaussian_circulant
    from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
    from repro_torch.kernels.wire_pack.ops import pack_wire, unpack_wire
    from repro_torch.launch.cost_walk import walk
    from repro_torch.ops import tune

    mesh = make_mesh((1,), ("model",))
    n = side * side
    op = partial_gaussian_circulant(torch.Generator().manual_seed(1), n, n // 2,
                                    normalize=True, device=mesh.device)
    wrappers = {"cpadmm_tail": fused_cpadmm_tail, "pack_wire": pack_wire,
                "unpack_wire": unpack_wire}
    out = {}
    for wire in ("fp32", "bf16"):
        pl = plan(op, mesh, rfft=True, tail="kernel", wire_dtype=wire)
        operands = tune._block_operands(pl, frames)
        pl.cpadmm_block(1)(*operands)
        before = {k: w.launches for k, w in wrappers.items()}
        cost = walk(pl.cpadmm_block(4), *operands)
        counted = {k: w.launches - before[k] for k, w in wrappers.items()}
        out[wire] = dict(heard=cost.kernel_launches, counted={k: v for k, v in counted.items()
                                                               if v})
    return out
