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
from repro_torch.ops.plan import plan


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
