"""Recovery-as-a-service launcher: serve a stream of compressed signals.

    python -m repro_torch.launch.serve --n 16384 --requests 32 \
        --rate 200 --slots 8

Port of ``repro/launch/serve.py``.  Stands up a
:class:`repro_torch.serve.RecoveryServer` (the continuous-batching
dispatcher) and drives it with a seeded synthetic Poisson stream of
heterogeneous recovery requests (mixed tolerances, optional priorities and
deadlines) over one sensing operator.  Converged slots are recycled to
queued requests mid-run, so the batch never drains to its stragglers;
``--compare-static`` also serves the same stream through the fixed-wave
baseline and reports the throughput ratio.

``--mesh`` routes every bucket's engine through the distributed plan layer
(``repro_torch.ops.plan.plan(op, mesh)``), with the specs of
``repro_torch.launch.recover``: ``--mesh 1`` is this process alone (NCCL on
the card), ``--fake-devices N`` starts N gloo ranks here, all on
``--device``, and every rank runs the same scheduler on rank 0's clock.
``--rfft``, ``--overlap`` and ``--n1`` set the mesh buckets' plan (the
reference parses them and leaves them unused).  ``--tune`` (or ``--tune
measure``) asks the plan autotuner (:mod:`repro_torch.ops.tune`) for each
mesh bucket's plan instead, as the reference's server does: a warm store
answers at once, and the report says whether it did.
Everything runs on the CUDA card unless ``--device cpu`` is given; there a
local bucket's round is a captured CUDA graph.

Reports signals/sec, p50/p99 latency, convergence/expiry counts, and the
recycling statistics.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from ..core.circulant import partial_gaussian_circulant
from ..data.synthetic import paper_regime
from ..device import resolve_device
from ..dist import compat
from ..ops import tune as tune_mod
from ..ops.plan import PlanConfig, resolve_tail
from ..serve import RecoveryServer, WallClock, static_batch_serve, summarize, synthetic_workload
from .recover import mesh_axes, parse_mesh

METHODS = ("cpadmm", "ista", "fista")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="continuous-batching recovery server (see module docstring)"
    )
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate (requests/second)")
    ap.add_argument("--slots", type=int, default=8,
                    help="batch lanes per bucket engine")
    ap.add_argument("--round-iters", type=int, default=32,
                    help="solver iterations per scheduling round")
    ap.add_argument("--method", default="cpadmm", choices=METHODS,
                    metavar=f"{{{','.join(METHODS)}}}")
    ap.add_argument("--tols", type=float, nargs="+",
                    default=[1e-3, 1e-3, 1e-3, 1e-6],
                    help="per-request tolerance draw (repeat a value to "
                         "weight it; the default is the ragged 3:1 mix)")
    ap.add_argument("--max-iters", type=int, default=2000)
    ap.add_argument("--min-iters", type=int, default=50)
    ap.add_argument("--priorities", type=int, nargs="+", default=[0],
                    help="per-request priority draw (larger runs first)")
    ap.add_argument("--deadline-slack", type=float, default=None,
                    help="per-request deadline = arrival + slack seconds "
                         "(expired requests return flagged partials)")
    ap.add_argument("--alpha", type=float, default=1e-4)
    ap.add_argument("--rho", type=float, default=0.01)
    ap.add_argument("--sigma", type=float, default=0.01)
    ap.add_argument("--compare-static", action="store_true",
                    help="also serve the identical stream through the "
                         "fixed-wave static baseline and report the ratio")
    ap.add_argument("--mesh", default=None,
                    help="distributed engines: 'M' (model axis) or 'DxM'")
    ap.add_argument("--rfft", action="store_true")
    ap.add_argument("--overlap", type=int, default=1)
    ap.add_argument("--n1", type=int, default=None)
    ap.add_argument("--tune", nargs="?", const="model", default=None,
                    choices=("model", "measure"),
                    help="autotune each mesh bucket's plan (repro_torch.ops.tune): bare "
                         "--tune ranks candidates by the cost model, --tune measure also "
                         "times the best; warm runs hit the plan store")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="start N gloo ranks here, all on --device (with --mesh)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.fake_devices:
        if args.mesh is None:
            raise SystemExit("--fake-devices starts the ranks of a --mesh; pass --mesh too")
        mesh_axes(args.mesh)  # a bad spec fails here, before any rank starts
        device = resolve_device(args.device)  # raises without CUDA unless --device cpu
        compat.spawn_fake_devices(args.fake_devices, run, args, device=str(device))
        return
    run(args)


def run(args) -> None:
    """The serving job on this rank: every rank of a mesh runs the same
    scheduler over the same stream, rank 0 reports."""
    mesh, _ = parse_mesh(args.mesh, args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    say = print if mesh is None or torch.distributed.get_rank() == 0 else (lambda *a: None)
    m, k = paper_regime(args.n)
    op = partial_gaussian_circulant(torch.Generator().manual_seed(args.seed + 1), args.n, m,
                                    normalize=True, device=device)
    reqs = synthetic_workload(
        op, args.requests, rate=args.rate, seed=args.seed, tols=args.tols,
        max_iters=args.max_iters, min_iters=args.min_iters,
        priorities=args.priorities, deadline_slack=args.deadline_slack,
        method=args.method,
    )
    if mesh is not None and not args.tune:
        cfg = PlanConfig(rfft=args.rfft, overlap=args.overlap, n1=args.n1,
                         tail=resolve_tail(None, device=device))
        reqs = [dataclasses.replace(r, plan_config=cfg) for r in reqs]
    say(f"serving {args.requests} requests, n={args.n}, m={m}, k={k}, "
        f"rate={args.rate}/s, slots={args.slots}, method={args.method}"
        + (f", mesh={args.mesh} (plan API)" if args.mesh else ""))

    srv = RecoveryServer(mesh=mesh, slots=args.slots, round_iters=args.round_iters,
                         alpha=args.alpha, rho=args.rho, sigma=args.sigma,
                         tune=args.tune or False, clock=WallClock())
    tune_mod.reset_counters()
    srv.warmup(reqs[0])
    if args.tune and mesh is not None:
        hits = tune_mod.COUNTERS["cache_hits"]
        for eng in srv.engines.values():
            say(f"tuned plan [{args.tune}]: {eng.plan.config.describe()} "
                f"({'cache hit' if hits else 'tuned, stored'})")
    srv.clock = WallClock()
    results = srv.serve(reqs)
    s = summarize(results)
    stats = srv.stats()

    say(f"continuous: {s['signals_per_sec']:.2f} signals/s, "
        f"p50 {s['p50_latency_s']:.3f}s, p99 {s['p99_latency_s']:.3f}s, "
        f"converged {s['converged']}/{s['count']}, "
        f"expired {s['expired']}")
    t = stats["total"]
    say(f"  buckets {stats['buckets']}, admitted {t['admitted']}, "
        f"recycled {t['recycled']}, rounds {t['rounds']}, "
        f"slot-iterations {t['slot_iters']}")

    if args.compare_static:
        b = summarize(static_batch_serve(reqs, server=srv, clock=WallClock()))
        ratio = s["signals_per_sec"] / b["signals_per_sec"]
        say(f"static baseline: {b['signals_per_sec']:.2f} signals/s, "
            f"p50 {b['p50_latency_s']:.3f}s, "
            f"p99 {b['p99_latency_s']:.3f}s")
        say(f"continuous vs static: {ratio:.2f}x signals/s")


if __name__ == "__main__":
    main(sys.argv[1:])
