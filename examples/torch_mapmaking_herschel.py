"""Herschel-style multi-observation map-making on the port, under the TV prior.

    PYTHONPATH=src python examples/torch_mapmaking_herschel.py [--frames 4 --size 32]
        [--mesh 2x2 --fake-devices 4] [--prior tv|l1|both] [--device cpu]

A space observatory scans the same sky patch at small pointing offsets and
fuses the exposures into one map.  Under the paper's compressed-sensing
telescope model each offset frame is the same joint operator A = P (C B)
applied to a shifted sky (``repro_torch.core.mapmaking``), so the whole
stack recovers through ONE planned operator with frames as the batch, then
co-adds by unshifting:

    y_f = A roll(sky, s_f)      recover z_f jointly      map = mean_f roll(z_f, -s_f)

The blurred, shifted frames are not sparse point fields, so the paper's l1
soft threshold is the wrong prior; the TV prox recovers the map markedly
better, and the example prints the PSNR table for both.  ``--mesh`` with
``--fake-devices N`` starts N gloo ranks here, all on ``--device``;
``--mesh 1`` alone runs a one-rank mesh (NCCL on the card).  Runs on the
CUDA card unless ``--device cpu`` is given.
"""

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core.mapmaking import (
    build_mapmaking_plan,
    build_mapmaking_problem,
    solve_mapmaking,
)
from repro_torch.data.synthetic import extended_emission
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
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--blur-sigma", type=float, default=1.5)
    ap.add_argument("--method", default="cpadmm", choices=("cpadmm", "ista", "fista"))
    ap.add_argument("--prior", default="both", choices=("tv", "l1", "both"),
                    help="recovery prior; 'both' prints the comparison table")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="start N gloo ranks here, all on --device (with --mesh)")
    ap.add_argument("--mesh", default=None, help="'M' (model axis) or 'DxM' (data x model)")
    ap.add_argument("--out", default="artifacts/torch_mapmaking")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    return ap


def run(args):
    """The job on this rank; rank 0 reports and returns the results."""
    mesh, _ = parse_mesh(args.mesh, args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    # extended dust and cloud emission, not a point field: gradient-sparse is
    # the regime where TV earns its keep (run --prior both and read the table)
    sky = extended_emission(torch.Generator().manual_seed(7), args.size, args.size,
                            n_sources=3, device=device)
    # dither pattern: horizontal and vertical unit offsets around the pointing
    offsets = [0, 1, args.size, args.size + 1, 2, 2 * args.size]
    shifts = offsets[: args.frames]
    prob = build_mapmaking_problem(torch.Generator().manual_seed(11), sky, shifts,
                                   blur_order=args.blur_sigma, subsample=0.5,
                                   sensing="romberg", blur_kind="gaussian")
    say(f"{len(shifts)} dithered exposures of a {args.size}x{args.size} sky, gaussian PSF "
        f"sigma={args.blur_sigma}, m={prob.deblur.op.m}, one shared operator, device={device}"
        + (f"; mesh={args.mesh} (plan API)" if args.mesh else ""))

    priors = ("tv", "l1") if args.prior == "both" else (args.prior,)
    results = {}
    for prior in priors:
        pl = build_mapmaking_plan(prob, mesh, prox="tv" if prior == "tv" else None)
        t0 = time.time()
        z_hat, m = solve_mapmaking(prob, plan=pl, method=args.method, iters=args.iters,
                                   alpha=1e-4)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        results[prior] = (z_hat, m, time.time() - t0)
        say(f"  {prior}: {pl.config.describe()}")
    if not lead:
        return None

    print(f"\n  {'prior':<8} {'map PSNR':>10} {'map RMS':>10} {'wall':>8}")
    for prior, (_, m, wall) in results.items():
        print(f"  {prior:<8} {float(m['psnr_db']):>8.1f} dB "
              f"{float(m['rms']):>10.2e} {wall:>7.1f}s")

    os.makedirs(args.out, exist_ok=True)
    save_pgm(os.path.join(args.out, "sky_true.pgm"), sky)
    for prior, (_, m, _) in results.items():
        save_pgm(os.path.join(args.out, f"map_{prior}.pgm"), m["map"])
    print(f"\nrenders in {args.out}/{{sky_true,map_*}}.pgm")
    return dict(problem=prob, results={p: (z, m) for p, (z, m, _) in results.items()})


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.fake_devices:
        if args.mesh is None:
            raise SystemExit("--fake-devices starts the ranks of a --mesh; pass --mesh too")
        mesh_axes(args.mesh)  # a bad spec fails here, before any rank starts
        device = resolve_device(args.device)
        return spawn_fake_devices(args.fake_devices, run, args, device=str(device))[0]
    return run(args)


if __name__ == "__main__":
    main()
