"""Recovery launcher: batched CS recovery with checkpoint/restart, on the card.

    python -m repro_torch.launch.recover --n 65536 --batch 4 \
        --method cpadmm --iters 600 --ckpt-dir artifacts/torch_recover_ckpt

Port of the local paths of ``repro/launch/recover.py``.  A batch of
compressively sensed signals (one shared sensing operator, ``--batch``
independent signals) is recovered with the selected solver, checkpointing
the solver state every ``--chunk`` iterations; a second run with the same
``--ckpt-dir`` resumes from the latest checkpoint.  ``--tol`` switches to
the tolerance-driven driver: convergence is tracked per signal (early
finishers freeze while the rest iterate) and the per-signal iteration
counts are reported.

``--deblur`` runs the paper's Sec. 7 scenario instead: ``--batch``
starfield frames of ``--size`` x ``--size`` sensed through one joint
operator ``A = P (C B)`` (an order-``--blur-order`` blur composed with the
``--sensing`` circulant, m = n/2), recovered by one batched solve, with
per-frame PSNR reported.

Everything runs on the CUDA card unless ``--device cpu`` is given.  The
data come from ``torch.Generator`` seeds (``--seed``), drawn on the CPU so
that one seed gives the same problem on either device; they differ from
the reference's ``jax.random`` draws, and the default checkpoint
directories are the port's own so that neither package resumes the
other's run.  The distributed flags (``--mesh`` and its companions),
``--tune`` and the non-l1 priors are not ported yet and exit with the
ROADMAP item that will bring them.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ckpt import checkpoint as ckpt
from ..core.circulant import partial_gaussian_circulant
from ..core.deblur import build_multiframe_deblur_problem, deblur_metrics
from ..core.solvers import RecoveryProblem, make_stepper, solve_checkpointed, solve_until
from ..data.synthetic import paper_regime, sparse_signal, starfield
from ..device import resolve_device
from ..ops.plan import plan

METHODS = ("cpadmm", "ista", "fista")
_DIST = "Queue 1 item 9 (distributed transforms and recovery)"
# flags of the reference launcher that wait for a later slice: (flag, the
# value that means "not given", the ROADMAP item that ports it)
UNPORTED = (
    ("mesh", None, _DIST), ("n1", None, _DIST), ("rfft", False, _DIST),
    ("overlap", 1, _DIST), ("wire_dtype", "fp32", _DIST), ("fake_devices", 0, _DIST),
    ("tune", None, "Queue 1 item 10 (tuner)"),
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="batched CS recovery launcher (see module docstring)"
    )
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--method", default="cpadmm", choices=METHODS,
                    metavar=f"{{{','.join(METHODS)}}}", help="solver method")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=1e-4)
    ap.add_argument("--tol", type=float, default=0.0,
                    help="run to per-signal convergence (relative-change "
                         "tolerance) instead of a fixed --iters budget")
    ap.add_argument("--deblur", action="store_true",
                    help="compressed-domain deblurring workload (Sec. 7): "
                         "--batch starfield frames sensed through one joint "
                         "A = P (C B) operator; reports per-frame PSNR")
    ap.add_argument("--blur-order", type=float, default=5,
                    help="blur width (with --deblur): raster length L for "
                         "moving-average, sigma for gaussian, first-null "
                         "radius for airy")
    ap.add_argument("--blur-kind", default="moving-average",
                    choices=("moving-average", "gaussian", "airy"),
                    help="PSF family for --deblur")
    ap.add_argument("--size", type=int, default=64,
                    help="frame extent: n = size*size (with --deblur)")
    ap.add_argument("--sensing", default="romberg", choices=("gaussian", "romberg"),
                    help="sensing circulant family (with --deblur)")
    ap.add_argument("--prior", default="l1", choices=("l1", "tv", "wavelet", "nonneg-l1"),
                    help="recovery prior; only l1 (the paper's soft threshold) "
                         "is ported yet")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: "
                         "artifacts/torch_recover_ckpt, or "
                         "artifacts/torch_recover_deblur_ckpt with --deblur)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch versions)")
    # the reference launcher's distributed and tuning flags, not ported yet
    ap.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--n1", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rfft", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--overlap", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--wire-dtype", default="fp32", help=argparse.SUPPRESS)
    ap.add_argument("--fake-devices", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--tune", nargs="?", const="model", default=None, help=argparse.SUPPRESS)
    return ap


def make_prior(prior: str):
    """CLI ``--prior`` name -> the prox (``None`` for l1, the paper's soft
    threshold, which keeps the fused kernel steps eligible)."""
    if prior == "l1":
        return None
    raise SystemExit(
        f"--prior {prior} is not ported yet: ROADMAP Queue 1 item 6 (the other "
        f"priors and scenarios); use --prior l1"
    )


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def build_deblur_workload(args, device):
    """The Sec. 7 workload: (problem, deblur_problem) for --deblur."""
    frames = torch.stack([
        starfield(_generator(args.seed + i), args.size, args.size, density=0.05,
                  n_blobs=2, device=device)
        for i in range(args.batch)
    ])
    dp = build_multiframe_deblur_problem(
        _generator(args.seed + 1), frames, blur_order=args.blur_order, subsample=0.5,
        sensing=args.sensing, blur_kind=args.blur_kind,
    )
    return RecoveryProblem(op=dp.op, y=dp.y, x_true=frames.reshape(args.batch, -1)), dp


def report_deblur(dp, x_hat) -> None:
    m = deblur_metrics(dp, x_hat)
    psnr = torch.atleast_1d(m["psnr_db"]).tolist()
    nmse = torch.atleast_1d(m["normalized_mse"]).tolist()
    for f, (p, e) in enumerate(zip(psnr, nmse)):
        print(f"  frame {f}: PSNR {p:.1f} dB   normalized MSE {e:.2e}")


def main(argv=None):
    args = _parser().parse_args(argv)
    for flag, unset, item in UNPORTED:
        if getattr(args, flag) != unset:
            raise SystemExit(
                f"--{flag.replace('_', '-')} is not ported yet: ROADMAP {item}"
            )
    prox = make_prior(args.prior)
    device = resolve_device(args.device)
    if args.ckpt_dir is None:
        args.ckpt_dir = ("artifacts/torch_recover_deblur_ckpt" if args.deblur
                         else "artifacts/torch_recover_ckpt")

    if args.deblur:
        n = args.size * args.size
        prob, dp = build_deblur_workload(args, device)
        print(f"deblurring batch={args.batch} frames of "
              f"{args.size}x{args.size} (n={n}), blur L={args.blur_order}, "
              f"m={dp.op.m}, sensing={args.sensing}, method={args.method}, "
              f"prior={args.prior}, device={device}")
    else:
        n = args.n
        m, k = paper_regime(n)
        dp = None
        print(f"recovering batch={args.batch} signals, n={n}, m={m}, k={k}, "
              f"method={args.method}, prior={args.prior}, device={device}")
        x_true = sparse_signal(_generator(args.seed), n, k, batch=(args.batch,),
                               device=device)
        op = partial_gaussian_circulant(_generator(args.seed + 1), n, m, normalize=True,
                                        device=device)
        prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)
    pl = plan(prob.op, prox=prox)
    kw = dict(alpha=args.alpha, rho=0.01, sigma=0.01, plan=pl)

    if args.tol > 0:
        t0 = time.time()
        x_hat, iters_used = solve_until(prob, args.method, tol=args.tol,
                                        max_iters=args.iters, **kw)
        d = prob.x_true - x_hat
        mse = torch.atleast_1d((d * d).mean(dim=-1)).tolist()
        print(f"finished in {time.time()-t0:.1f}s; per-signal iterations: "
              f"{torch.atleast_1d(iters_used).tolist()}")
        print(f"per-signal MSE: {[f'{v:.2e}' for v in mse]}")
        if dp is not None:
            report_deblur(dp, x_hat)
        return

    restore = None
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is not None:
        # the saved tree is the solver state; a fresh stepper's init state
        # gives its structure and the device to restore onto
        like = make_stepper(prob, args.method, **kw).init()
        restore = ckpt.restore(args.ckpt_dir, latest, like)
        print(f"resumed from iteration {restore[0]}")

    t0 = time.time()
    x_hat, mse = solve_checkpointed(
        prob, args.method, iters=args.iters, chunk=args.chunk,
        save_cb=lambda s, st: ckpt.save(args.ckpt_dir, s, st), restore=restore, **kw,
    )
    print(f"finished in {time.time()-t0:.1f}s; per-signal MSE: "
          f"{[f'{v:.2e}' for v in torch.atleast_1d(mse).tolist()]}")
    if dp is not None:
        report_deblur(dp, x_hat)


if __name__ == "__main__":
    main(sys.argv[1:])
