#!/usr/bin/env python3
"""Time one checkout's kernels on one CUDA card, for comparing two checkouts.

    python3 matvec_sweep.py [CHECKOUT]
    python3 matvec_sweep.py --threshold [CHECKOUT]

Default: ``chip_smoke.py``'s crossover sweep of the direct circulant matvec
against the FFT path: n = 1024 ... 32768 at B = 8 and 1 signals, C x and
C^T x, device ms by CUDA events, and the n at which the FFT path first wins
beside that checkout's ``FFT_CROSSOVER``.

``--threshold``: the soft-threshold pair through their public wrappers at
the three shapes ``chip_smoke.py`` holds them at (eta_gamma(x + delta) and
the ADMM update, the scalars one-element tensors on the card, the form both
designs take), then Path C's CPISTA kernel step (n = 16384, B = 8): its
device and host ms and the device operations ``torch.profiler`` counts in
it.

The port timed is the one under ``CHECKOUT/src`` (default: this file's own
checkout); its kernels are built under ``CHECKOUT/build``.  To compare two
checkouts, run it on both on the same card, one after another, in the
order A, B, B, A.  Exits non-zero without a card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import chip_smoke


def threshold_sweep(dev) -> None:
    import torch

    from repro_torch.core.circulant import partial_gaussian_circulant
    from repro_torch.core.solvers import RecoveryProblem
    from repro_torch.data.synthetic import paper_regime, sparse_signal
    from repro_torch.kernels.soft_threshold.ops import fused_admm_update, fused_ista_update
    from repro_torch.ops.plan import plan

    gen = torch.Generator(device=dev).manual_seed(0)
    gamma, tau2 = torch.tensor(0.05, device=dev), torch.tensor(1.0, device=dev)
    for label, n, B in chip_smoke.THRESHOLD_SHAPES:
        x, other = (torch.randn(B, n, generator=gen, device=dev) for _ in range(2))
        ista = chip_smoke.timed(lambda: fused_ista_update(x, other, gamma))
        admm = chip_smoke.timed(lambda: fused_admm_update(x, other, gamma, tau2))
        print(f"threshold sweep [{label}: n={n} B={B}]: device ms soft_threshold_ista "
              f"{ista[0]:.4f}, soft_threshold_admm {admm[0]:.4f}; host ms {ista[1]:.4f}, "
              f"{admm[1]:.4f}")
    n = 16384
    m, k = paper_regime(n)
    g = torch.Generator().manual_seed(3)
    x_true = sparse_signal(g, n, k, batch=(8,), device=dev)
    op = partial_gaussian_circulant(g, n, m, normalize=True, device=dev)
    prob = RecoveryProblem(op=op, y=op.matvec(x_true), x_true=x_true)
    kw = dict(method="ista", alpha=1e-4)
    dev_ms, host_ms = chip_smoke.step_times(prob, plan(op, tail="kernel"), **kw)
    ops = chip_smoke.profile_steps(prob, plan(op, tail="kernel"), "Path C kernel step", **kw)
    print(f"threshold sweep [Path C's CPISTA kernel step, n={n} B=8]: device {dev_ms:.4f} ms, "
          f"host issue {host_ms:.4f} ms, {ops['launches']:g} device operations a step")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("matvec_sweep: no CUDA device available", file=sys.stderr)
        return 1
    threshold = "--threshold" in argv[1:]
    args = [a for a in argv[1:] if a != "--threshold"]
    root = Path(args[0]).resolve() if args else chip_smoke.ROOT
    sys.path.insert(0, str(root / "src"))
    import repro_torch

    print(chip_smoke.card_line())
    print(f"sweeping {Path(repro_torch.__file__).parent}")
    dev = torch.device("cuda", 0)
    if threshold:
        threshold_sweep(dev)
        return 0
    gen = torch.Generator(device=dev).manual_seed(0)
    chip_smoke.crossover_sweep(lambda *shape: torch.randn(*shape, generator=gen, device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
