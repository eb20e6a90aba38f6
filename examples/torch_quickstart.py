"""Quickstart on the port: recover a compressively sensed sparse signal.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The paper's core experiment (Sec. 6) at n = 4096 with ``repro_torch``: a
k-sparse signal sensed by a partial circulant at m = n/2 is recovered by
CPADMM and by FISTA to the paper's MSE <= 1e-4, the operator stored as one
length-n vector.  Runs on the CUDA card unless ``--device cpu`` is given;
on the card CPADMM takes the kernel step (at n = 4096, below the FFT
crossover, its C x is the direct circulant-matvec kernel).
"""

import argparse

import torch

from repro_torch.core import (
    PAPER_TARGET_MSE,
    RecoveryProblem,
    partial_gaussian_circulant,
    solve,
)
from repro_torch.data.synthetic import paper_regime, sparse_signal
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    n = 4096
    m, k = paper_regime(n)  # paper Sec. 6: m = n/2, k ~ n/10
    print(f"n={n}  measurements m={m}  sparsity k={k}  device={device}")

    x_true = sparse_signal(torch.Generator().manual_seed(0), n, k, device=device)
    op = partial_gaussian_circulant(torch.Generator().manual_seed(1), n, m, normalize=True,
                                    device=device)
    y = op.matvec(x_true)

    # O(n) operator storage vs O(mn) dense (paper Fig. 3)
    circ_bytes = op.circ.col.nbytes + op.omega.nbytes
    print(f"sensing operator storage: {circ_bytes/1e3:.1f} kB "
          f"(dense would be {m*n*4/1e6:.1f} MB)")

    prob = RecoveryProblem(op=op, y=y, x_true=x_true)
    out = {}
    for method, iters, kw in (
        ("cpadmm", 400, dict(alpha=1e-4, rho=0.01, sigma=0.01)),
        ("fista", 800, dict(alpha=1e-4)),  # FISTA needs ~2x CPADMM's iterations here
    ):
        x_hat, trace = solve(prob, method, iters=iters, record_every=iters // 4, **kw)
        mses = [float(v) for v in trace.mse]
        ok = "recovered" if mses[-1] < PAPER_TARGET_MSE else "NOT recovered"
        print(f"{method:8s} mse trace {[f'{v:.2e}' for v in mses]}  -> {ok}")
        out[method] = dict(x_hat=x_hat, mse=mses)
    return out


if __name__ == "__main__":
    main()
