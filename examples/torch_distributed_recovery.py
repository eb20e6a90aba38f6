"""Distributed recovery on the port through the execution-plan layer.

    PYTHONPATH=src python examples/torch_distributed_recovery.py [--fake-devices 4]
        [--method cpadmm|ista|fista] [--overlap K] [--tail plain|kernel] [--device cpu]

One large signal split over a mesh's model axis by the four-step FFT, run
by the same solver drivers as a one-device solve, with checkpoint/restart:
``plan(op, mesh)`` lowers the sensing operator, ``solve_checkpointed``
recovers a 64k-sample signal, stops halfway (a simulated preemption) and
restarts from the checkpoint, which must give the uninterrupted run's
result bit for bit.  ``--fake-devices N`` starts N gloo ranks here, all on
``--device``; with no flag the mesh is one rank, NCCL on the card.  Runs on
the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import shutil

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import RecoveryProblem, solve_checkpointed
from repro_torch.core.circulant import PartialCirculant, gaussian_circulant
from repro_torch.core.solvers import make_stepper
from repro_torch.data.synthetic import paper_regime, sparse_signal
from repro_torch.device import resolve_device
from repro_torch.dist.compat import make_mesh, spawn_fake_devices
from repro_torch.ops.plan import plan

CKPT_DIR = "artifacts/torch_dist_recovery_ckpt"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="start N gloo ranks here, all on --device (default: one NCCL rank)")
    ap.add_argument("--n1", type=int, default=256)
    ap.add_argument("--n2", type=int, default=256)
    ap.add_argument("--method", default="cpadmm", choices=("cpadmm", "ista", "fista"),
                    help="every method runs distributed through the plan")
    ap.add_argument("--rfft", action="store_true",
                    help="half-spectrum transforms (half the wire bytes)")
    ap.add_argument("--overlap", type=int, default=1,
                    help="chunked-transpose overlap factor K (1 = monolithic)")
    ap.add_argument("--tail", default=None, choices=("plain", "kernel"),
                    help="elementwise iteration tail (default: the kernels on the card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    return ap


def run(args):
    """The job on this rank; rank 0 reports and returns the results."""
    n1, n2 = args.n1, args.n2
    n = n1 * n2
    ranks = max(1, args.fake_devices)
    mesh = make_mesh((ranks,), ("model",), device=args.device)
    lead = torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    m, k = paper_regime(n)
    say(f"n={n} over {ranks} rank(s) on {mesh.device}; m={m}, k={k}, method={args.method}")

    # every rank draws the same problem from the same seeds
    x_true = sparse_signal(torch.Generator().manual_seed(0), n, k, device=mesh.device)
    C = gaussian_circulant(torch.Generator().manual_seed(1), n, normalize=True,
                           device=mesh.device)
    omega = torch.sort(torch.randperm(n, generator=torch.Generator().manual_seed(2))[:m]).values
    op = PartialCirculant(C, omega.to(mesh.device))
    prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)

    # one call lowers the operator onto the mesh; the drivers are unchanged
    pl = plan(op, mesh, n1=n1, n2=n2, rfft=args.rfft, overlap=args.overlap, tail=args.tail)
    say(f"plan: {pl.config.describe()}")
    kw = dict(alpha=1e-4, rho=0.01, sigma=0.01, plan=pl, chunk=50)

    def save(step, state):
        ckpt.save(CKPT_DIR, step, state, plan=pl)

    # --- the first 100 iterations, checkpointing every chunk
    solve_checkpointed(prob, args.method, iters=100, save_cb=save, **kw)
    say("  -- simulated preemption after iter 100: restarting --")

    # --- restart from the latest checkpoint and run to 200
    like = make_stepper(prob, args.method, **{k_: v for k_, v in kw.items()
                                              if k_ != "chunk"}).init()
    step_no, state = ckpt.restore(CKPT_DIR, None, like, plan=pl)
    if step_no != 100:
        raise RuntimeError(f"restored step {step_no}, expected 100")
    x_hat, mse = solve_checkpointed(prob, args.method, iters=200, save_cb=save,
                                    restore=(step_no, state), **kw)

    # --- the uninterrupted run: the restart must be bit-identical
    x_ref, _ = solve_checkpointed(prob, args.method, iters=200, **kw)
    identical = torch.equal(x_hat, x_ref)
    say(f"restart-vs-uninterrupted bit-identical: {identical}")
    if not identical:
        raise RuntimeError("the restarted solve differs from the uninterrupted one")

    final = float(mse.mean())
    say(f"final MSE {final:.2e}  ({'OK' if final < 1e-4 else 'needs more iters'})")
    return dict(x_hat=x_hat, mse=final, identical=identical) if lead else None


def main(argv=None):
    args = _parser().parse_args(argv)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)  # stale steps would win "latest"
    if args.fake_devices:
        device = resolve_device(args.device)
        return spawn_fake_devices(args.fake_devices, run, args, device=str(device))[0]
    return run(args)


if __name__ == "__main__":
    main()
