"""Multi-frame compressed deblurring on the port, with checkpoint/restart.

    PYTHONPATH=src python examples/torch_deblur_multiframe.py [--frames 4 --size 64]
        [--mesh 2x2 --fake-devices 4 --rfft] [--method cpadmm|ista|fista]
        [--device cpu]

F starfield frames are sensed through one shared blur-and-sensing operator
A = P (C B) and recovered by one batched solve, lowered by
``build_deblur_plan``: with ``--mesh`` onto a (data, model) mesh, frames
over the data axis and each frame's four-step transforms over the model
axis.  ``--mesh M`` or ``DxM`` with ``--fake-devices N`` starts N gloo
ranks here, all on ``--device``; ``--mesh 1`` alone runs a one-rank mesh
(NCCL on the card), as the recovery CLI does.

The solve runs through ``solve_checkpointed``: it stops halfway (a
simulated preemption), restarts from the latest checkpoint, and the
restarted stack must equal an uninterrupted run bit for bit.  Per-frame
PSNR and PGM renders come out as in the single-frame example.  Runs on the
CUDA card unless ``--device cpu`` is given.
"""

import argparse
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import RecoveryProblem, solve_checkpointed
from repro_torch.core.deblur import (
    blurred_observation,
    build_deblur_plan,
    build_multiframe_deblur_problem,
    deblur_metrics,
    recovered_image,
)
from repro_torch.core.solvers import make_stepper
from repro_torch.data.synthetic import starfield
from repro_torch.device import resolve_device
from repro_torch.dist.compat import spawn_fake_devices
from repro_torch.launch.recover import mesh_axes, parse_mesh


def save_pgm(path: str, img: torch.Tensor) -> None:
    arr = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5 {w} {h} 255\n".encode())
        f.write(np.ascontiguousarray(arr).tobytes())


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--blur-order", type=int, default=5)
    ap.add_argument("--method", default="cpadmm", choices=("cpadmm", "ista", "fista"),
                    help="every method runs distributed through the plan")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="start N gloo ranks here, all on --device (with --mesh)")
    ap.add_argument("--mesh", default=None,
                    help="'M' (model axis) or 'DxM' (data x model); default: one-device plan")
    ap.add_argument("--rfft", action="store_true",
                    help="half-spectrum transforms (half the wire bytes)")
    ap.add_argument("--overlap", type=int, default=1,
                    help="chunked-transpose overlap factor K")
    ap.add_argument("--out", default="artifacts/torch_deblur_multiframe")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    return ap


def run(args):
    """The job on this rank; rank 0 reports and returns the results."""
    mesh, batch_axis = parse_mesh(args.mesh, args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    frames = torch.stack([
        starfield(torch.Generator().manual_seed(i), args.size, args.size, density=0.10,
                  n_blobs=6, device=device)
        for i in range(args.frames)
    ])
    p = build_multiframe_deblur_problem(torch.Generator().manual_seed(100), frames,
                                        blur_order=args.blur_order, subsample=0.5,
                                        sensing="romberg")
    n = args.size * args.size
    pl = build_deblur_plan(p, mesh, rfft=args.rfft, overlap=args.overlap,
                           batch_axis=batch_axis)
    say(f"{args.frames} frames of {args.size}x{args.size} (n={n}), blur L={args.blur_order}, "
        f"m={p.op.m}, one shared operator, device={device}, step: tail={pl.tail}"
        + (f"; mesh={args.mesh} (plan API)" if args.mesh else ""))

    prob = RecoveryProblem(op=p.op, y=p.y, x_true=frames.reshape(args.frames, -1))
    kw = dict(alpha=1e-3, rho=0.01, sigma=0.01, plan=pl, chunk=args.chunk)
    ckdir = os.path.join(args.out, "ckpt")

    def save(step, state):
        ckpt.save(ckdir, step, state, plan=pl)

    # --- the first half of the budget, checkpointing every chunk, then "die"
    half = max(args.chunk, (args.iters // 2) // args.chunk * args.chunk)
    t0 = time.time()
    solve_checkpointed(prob, args.method, iters=half, save_cb=save, **kw)
    say(f"  -- simulated preemption after iter {half}: restarting --")

    # --- restart from the latest checkpoint and run out the full budget
    like = make_stepper(prob, args.method, **{k: v for k, v in kw.items() if k != "chunk"}).init()
    step_no, state = ckpt.restore(ckdir, None, like, plan=pl)
    if step_no != half:
        raise RuntimeError(f"restored step {step_no}, expected {half}")
    x_hat, _ = solve_checkpointed(prob, args.method, iters=args.iters, save_cb=save,
                                  restore=(step_no, state), **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0

    # --- the uninterrupted run: the restarted stack must be bit-identical
    x_ref, _ = solve_checkpointed(prob, args.method, iters=args.iters, **kw)
    identical = torch.equal(x_hat, x_ref)
    say(f"restart-vs-uninterrupted bit-identical: {identical}")
    if not identical:
        raise RuntimeError("the restarted solve differs from the uninterrupted one")
    if mesh is not None:
        x_hat = pl.gather_batch(x_hat)
    if not lead:
        return None

    m = deblur_metrics(p, x_hat)
    print(f"recovered the whole stack in {wall:.1f}s / {args.iters} iters "
          f"({wall / args.frames:.1f}s per frame, one solve + one restart)")
    for f in range(args.frames):
        print(f"  frame {f}: PSNR {float(m['psnr_db'][f]):.1f} dB   "
              f"normalized MSE {float(m['normalized_mse'][f]):.2e}")

    os.makedirs(args.out, exist_ok=True)
    rec, blur = recovered_image(p, x_hat), blurred_observation(p)
    for f in range(args.frames):
        save_pgm(os.path.join(args.out, f"frame{f}_original.pgm"), frames[f])
        save_pgm(os.path.join(args.out, f"frame{f}_blurred.pgm"), blur[f])
        save_pgm(os.path.join(args.out, f"frame{f}_recovered.pgm"), rec[f])
    print(f"renders in {args.out}/frame*_{{original,blurred,recovered}}.pgm")
    return dict(x_hat=x_hat, metrics=m, identical=identical)


def main(argv=None):
    args = _parser().parse_args(argv)
    shutil.rmtree(os.path.join(args.out, "ckpt"), ignore_errors=True)  # stale steps win "latest"
    if args.fake_devices:
        if args.mesh is None:
            raise SystemExit("--fake-devices starts the ranks of a --mesh; pass --mesh too")
        mesh_axes(args.mesh)  # a bad spec fails here, before any rank starts
        device = resolve_device(args.device)
        return spawn_fake_devices(args.fake_devices, run, args, device=str(device))[0]
    return run(args)


if __name__ == "__main__":
    main()
