#!/usr/bin/env python3
"""Sweep one checkout's direct circulant matvec kernel against the FFT path.

    python3 matvec_sweep.py [CHECKOUT]

Runs ``chip_smoke.py``'s crossover sweep on one CUDA card: n = 1024 ...
32768 at B = 8 and 1 signals, C x and C^T x, device ms by CUDA events, and
the n at which the FFT path first wins beside that checkout's
``FFT_CROSSOVER``.  The port swept is the one under ``CHECKOUT/src``
(default: this file's own checkout); its CUDA kernels are built under
``CHECKOUT/build``.  To compare the kernels of two checkouts, run it on both
on the same card, one after another, in the order A, B, B, A.  Exits non-zero
without a card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import chip_smoke


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("matvec_sweep: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(argv[1]).resolve() if len(argv) > 1 else chip_smoke.ROOT
    sys.path.insert(0, str(root / "src"))
    import repro_torch

    print(chip_smoke.card_line())
    print(f"sweeping {Path(repro_torch.__file__).parent}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    chip_smoke.crossover_sweep(lambda *shape: torch.randn(*shape, generator=gen, device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
