"""Compressed astronomical-image deblurring on the port (paper Sec. 7, Fig. 9).

    PYTHONPATH=src python examples/torch_deblur_astronomy.py [--size 128] [--iters 600]
        [--device cpu]

A synthetic starfield (the stand-in for the Abell-2744 Hubble frame) is
blurred by the paper's order-5 raster filter, sparse-sampled at m = n/2
and jointly un-blurred and reconstructed by CPADMM, since A = P (C B) is
still partial circulant.  Saves PGM renders of the original, blurred and
recovered frames.  Runs on the CUDA card (the kernel step) unless
``--device cpu`` is given.
"""

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core import RecoveryProblem, solve
from repro_torch.core.deblur import (
    blurred_observation,
    build_deblur_problem,
    deblur_metrics,
    recovered_image,
)
from repro_torch.data.synthetic import starfield
from repro_torch.device import resolve_device


def save_pgm(path: str, img: torch.Tensor) -> None:
    arr = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5 {w} {h} 255\n".encode())
        f.write(np.ascontiguousarray(arr).tobytes())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--blur-order", type=int, default=5)
    ap.add_argument("--out", default="artifacts/torch_deblur")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    img = starfield(torch.Generator().manual_seed(0), args.size, args.size, density=0.10,
                    n_blobs=8, device=device)
    p = build_deblur_problem(torch.Generator().manual_seed(1), img, blur_order=args.blur_order,
                             subsample=0.5, sensing="romberg")
    n = img.numel()
    print(f"image {args.size}x{args.size} (n={n}), blur L={args.blur_order}, m={p.op.m}, "
          f"device={device}")

    prob = RecoveryProblem(op=p.op, y=p.y, x_true=img.reshape(-1))
    t0 = time.time()
    x_hat, _ = solve(prob, "cpadmm", iters=args.iters, record_every=max(1, args.iters // 6),
                     alpha=1e-3, rho=0.01, sigma=0.01)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0

    m = deblur_metrics(p, x_hat)
    print(f"recovered in {wall:.1f}s / {args.iters} iters")
    print(f"  normalized MSE      : {float(m['normalized_mse']):.2e} (paper: ~1e-4 order)")
    print(f"  abs err / mean int. : {float(m['mean_abs_err_over_mean_intensity']):.4f} "
          f"(paper: 0.0157)")
    print(f"  PSNR                : {float(m['psnr_db']):.1f} dB")
    os.makedirs(args.out, exist_ok=True)
    save_pgm(os.path.join(args.out, "original.pgm"), img)
    save_pgm(os.path.join(args.out, "blurred.pgm"), blurred_observation(p))
    save_pgm(os.path.join(args.out, "recovered.pgm"), recovered_image(p, x_hat))
    print(f"renders in {args.out}/{{original,blurred,recovered}}.pgm")
    return dict(problem=p, x_hat=x_hat, metrics=m)


if __name__ == "__main__":
    main()
