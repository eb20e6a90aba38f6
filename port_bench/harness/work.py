"""The least work of one CPADMM iteration, and the card's peaks.

A function of the algorithm and the shapes only, never of the program's
kernels, so a fused, renamed or removed kernel reads the same work.

The least bytes: the iteration must read the state the next step needs
(v, z, mu, nu: 4 arrays of B x n float32), the measurements (B x m
float32) and the spectrum of C (n // 2 + 1 complex64), and write the new
state (4 arrays).  x and C x live only inside the step; the row set
(which a bit mask could carry) and B's spectrum (which follows from C's)
are left out, and so are the FFTs' intermediate spectra: a step fused
around its transforms need not move them.  So no implementation moves
fewer bytes, and the share of the roofline cannot pass 100%.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth (bytes/s) at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32, C64 = 4, 8


def cpadmm_least_bytes(batch: int, n: int, m: int) -> int:
    state = 4 * batch * n * F32
    return 2 * state + batch * m * F32 + (n // 2 + 1) * C64


def least_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3
