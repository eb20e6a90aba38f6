"""Recovery launcher: batched CS recovery with checkpoint/restart, on the card.

    python -m repro_torch.launch.recover --n 65536 --batch 4 \
        --method cpadmm --iters 600 --ckpt-dir artifacts/torch_recover_ckpt

Port of ``repro/launch/recover.py``.  A batch of
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

``--mesh M`` (model axis) or ``--mesh DxM`` (data x model) routes the same
job through the distributed plan layer (``repro_torch.ops.plan.plan(op,
mesh)``): each signal is split over the model axis by the four-step FFT,
the batch over the data axis, and the same drivers run; ``--n1``,
``--rfft``, ``--overlap`` and ``--wire-dtype`` are the plan's knobs.  The
ranks come from ``torchrun --nproc-per-node P ... --mesh P`` (NCCL, one
card a rank), from ``--fake-devices N`` (N gloo ranks started here, all on
``--device``: the CPU, or one card they share), or, for ``--mesh 1``, from
this process alone.  Rank 0 alone prints and writes checkpoints, which
hold the global state.

Everything runs on the CUDA card unless ``--device cpu`` is given.  On
the card the plan's tail resolves to the hand-written kernel steps
(:func:`repro_torch.ops.plan.resolve_tail`), with no flag; on the CPU to
the plain steps.  The
data come from ``torch.Generator`` seeds (``--seed``), drawn on the CPU so
that one seed gives the same problem on either device and on every rank;
they differ from the reference's ``jax.random`` draws, and the default
checkpoint directories are the port's own so that neither package resumes
the other's run.  ``--prior`` picks the recovery prior (l1, the paper's;
nonneg-l1, tv or wavelet: the plain step, on a mesh too).  ``--tune`` is
not ported yet and exits with the ROADMAP item that will bring it.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from ..ckpt import checkpoint as ckpt
from ..core.circulant import partial_gaussian_circulant
from ..core.deblur import build_deblur_plan, build_multiframe_deblur_problem, deblur_metrics
from ..core.solvers import RecoveryProblem, make_stepper, solve_checkpointed, solve_until
from ..data.synthetic import paper_regime, sparse_signal, starfield
from ..device import resolve_device
from ..dist import compat
from ..kernels.wire_pack.ref import WIRE_DTYPES
from ..ops.plan import plan
from ..ops.prox import NonNegL1Prox, TVProx, WaveletProx, is_l1

METHODS = ("cpadmm", "ista", "fista")
# flags of the reference launcher that wait for a later slice: (flag, the
# value that means "not given", the ROADMAP item that ports it)
UNPORTED = (("tune", None, "Queue 1 item 10 (tuner)"),)


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
                    help="recovery prior: l1 (the paper's soft threshold, the "
                         "kernel steps on the card), or nonneg-l1, tv (needs a "
                         "square frame) or wavelet (the plain step)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: "
                         "artifacts/torch_recover_ckpt, or "
                         "artifacts/torch_recover_deblur_ckpt with --deblur)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--mesh", default=None,
                    help="distributed plan: 'M' (model axis size) or 'DxM' "
                         "(data x model); e.g. --mesh 4 or --mesh 2x2")
    ap.add_argument("--n1", type=int, default=None,
                    help="four-step row count for --mesh (auto near sqrt(n))")
    ap.add_argument("--rfft", action="store_true",
                    help="half-spectrum distributed transforms (with --mesh)")
    ap.add_argument("--overlap", type=int, default=1,
                    help="chunked-transpose overlap factor K (with --mesh)")
    ap.add_argument("--wire-dtype", default="fp32", choices=tuple(WIRE_DTYPES),
                    help="transpose all-to-all payload precision (with --mesh): "
                         "bf16/fp16 halve the wire bytes, guarded by an fp32 "
                         "fallback past the plan layer's precision bound")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="start N gloo ranks here, all on --device (with --mesh)")
    # the reference launcher's tuning flag, not ported yet
    ap.add_argument("--tune", nargs="?", const="model", default=None, help=argparse.SUPPRESS)
    return ap


def make_prior(prior: str, n: int, size=None):
    """CLI ``--prior`` name -> the prox (``None`` for l1, the paper's soft
    threshold, which keeps the fused kernel steps eligible).

    tv needs a 2-D extent: ``size`` (``--size`` under ``--deblur``), else a
    square ``n``.
    """
    if prior == "l1":
        return None
    if prior == "nonneg-l1":
        return NonNegL1Prox()
    if prior == "wavelet":
        return WaveletProx()
    if prior == "tv":
        if size is not None:
            return TVProx(shape=(size, size))
        side = math.isqrt(n)
        if side * side != n:
            raise SystemExit(
                f"--prior tv needs a square frame: n={n} is not a perfect "
                f"square (use --deblur --size, or a square --n)"
            )
        return TVProx(shape=(side, side))
    raise ValueError(f"unknown prior {prior!r}")


def _prior(args):
    return make_prior(args.prior, args.size * args.size if args.deblur else args.n,
                      args.size if args.deblur else None)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def mesh_axes(mesh_arg):
    """CLI mesh spec 'M' or 'DxM' -> (shape, axis names, batch axis)."""
    shape = tuple(int(t) for t in mesh_arg.lower().split("x"))
    if len(shape) == 1:
        return shape, ("model",), None
    if len(shape) == 2:
        return shape, ("data", "model"), "data"
    raise ValueError(f"--mesh must be 'M' or 'DxM', got {mesh_arg!r}")


def parse_mesh(mesh_arg, device):
    """CLI mesh spec -> (mesh, batch_axis), or (None, None) without one.
    Joins the process group first (torchrun's, or a world of one)."""
    if mesh_arg is None:
        return None, None
    shape, names, batch_axis = mesh_axes(mesh_arg)
    return compat.make_mesh(shape, names, device=device), batch_axis


def plan_knobs(args) -> dict:
    """The plan knobs the CLI flags set."""
    return dict(rfft=args.rfft, overlap=args.overlap, wire_dtype=args.wire_dtype)


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
    _prior(args)  # a bad --prior fails here, before any rank starts
    if args.fake_devices:
        if args.mesh is None:
            raise SystemExit("--fake-devices starts the ranks of a --mesh; pass --mesh too")
        mesh_axes(args.mesh)  # a bad spec fails here, before any rank starts
        device = resolve_device(args.device)  # raises without CUDA unless --device cpu
        compat.spawn_fake_devices(args.fake_devices, run, args, device=str(device))
        return
    run(args)


def run(args) -> None:
    """The job on this rank: every rank of a mesh runs it, rank 0 reports."""
    prox = _prior(args)
    mesh, batch_axis = parse_mesh(args.mesh, args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    where = f", mesh={args.mesh}" if mesh is not None else ""
    if args.ckpt_dir is None:
        args.ckpt_dir = ("artifacts/torch_recover_deblur_ckpt" if args.deblur
                         else "artifacts/torch_recover_ckpt")

    if args.deblur:
        n = args.size * args.size
        prob, dp = build_deblur_workload(args, device)
        say(f"deblurring batch={args.batch} frames of "
            f"{args.size}x{args.size} (n={n}), blur L={args.blur_order}, "
            f"m={dp.op.m}, sensing={args.sensing}, method={args.method}, "
            f"prior={args.prior}, device={device}{where}")
        pl = build_deblur_plan(dp, mesh, n1=args.n1, batch_axis=batch_axis, prox=prox,
                               **plan_knobs(args))
    else:
        n = args.n
        m, k = paper_regime(n)
        dp = None
        say(f"recovering batch={args.batch} signals, n={n}, m={m}, k={k}, "
            f"method={args.method}, prior={args.prior}, device={device}{where}")
        x_true = sparse_signal(_generator(args.seed), n, k, batch=(args.batch,),
                               device=device)
        op = partial_gaussian_circulant(_generator(args.seed + 1), n, m, normalize=True,
                                        device=device)
        prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)
        if mesh is None:
            # the single validation site rejects --rfft/--overlap/--wire-dtype without --mesh
            pl = plan(op, prox=prox, **plan_knobs(args))
        else:
            pl = plan(op, mesh, n1=args.n1, batch_axis=batch_axis, prox=prox,
                      **plan_knobs(args))
    step = f"step: tail={pl.tail}"
    if pl.tail == "kernel":
        # the kernel steps bake in the soft threshold; another prior takes the plain step
        step += " (the hand-written kernels)" if is_l1(prox) else " (l1 only: the plain step runs)"
    say(step)
    kw = dict(alpha=args.alpha, rho=0.01, sigma=0.01, plan=pl)
    gather = pl.gather_batch if mesh is not None else (lambda t: t)

    if args.tol > 0:
        t0 = time.time()
        x_hat, iters_used = solve_until(prob, args.method, tol=args.tol,
                                        max_iters=args.iters, **kw)
        x_hat, iters_used = gather(x_hat), gather(iters_used)
        d = prob.x_true - x_hat
        mse = torch.atleast_1d((d * d).mean(dim=-1)).tolist()
        say(f"finished in {time.time()-t0:.1f}s; per-signal iterations: "
            f"{torch.atleast_1d(iters_used).tolist()}")
        say(f"per-signal MSE: {[f'{v:.2e}' for v in mse]}")
        if dp is not None and lead:
            report_deblur(dp, x_hat)
        return

    restore = None
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is not None:
        # the saved tree is the solver state; a fresh stepper's init state
        # gives its structure and the device to restore onto
        like = make_stepper(prob, args.method, **kw).init()
        restore = ckpt.restore(args.ckpt_dir, latest, like, plan=pl)
        say(f"resumed from iteration {restore[0]}")

    t0 = time.time()
    x_hat, mse = solve_checkpointed(
        prob, args.method, iters=args.iters, chunk=args.chunk,
        save_cb=lambda s, st: ckpt.save(args.ckpt_dir, s, st, plan=pl), restore=restore, **kw,
    )
    x_hat, mse = gather(x_hat), gather(mse)
    say(f"finished in {time.time()-t0:.1f}s; per-signal MSE: "
        f"{[f'{v:.2e}' for v in torch.atleast_1d(mse).tolist()]}")
    if dp is not None and lead:
        report_deblur(dp, x_hat)


if __name__ == "__main__":
    main(sys.argv[1:])
