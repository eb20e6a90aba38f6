"""Shared spectral helpers: the rfft pair and the CPADMM gram inverse.

Port of ``repro/ops/spectral.py`` (the single-device half).  Transforms act
on the trailing axis and broadcast over leading batch axes.  On the card
they are ``torch.fft`` (cuFFT), as the reference's are XLA's FFT.  The
four-step half-spectrum layout helpers come with the distributed slice.
"""

from __future__ import annotations

import torch


def rfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """Length-``n`` real FFT along the trailing axis."""
    return torch.fft.rfft(x, n=n, dim=-1)


def irfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """Length-``n`` inverse real FFT along the trailing axis."""
    return torch.fft.irfft(x, n=n, dim=-1)


def apply_spectrum(spec: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """``irfft(spec * rfft(x))`` — one circulant application by the
    convolution theorem (paper Sec. 4's C = F^H diag(spec) F identity)."""
    return irfft(spec * rfft(x, n), n)


def gram_inverse_spectrum(spec: torch.Tensor, rho, sigma) -> torch.Tensor:
    """Spectrum of ``(rho C^T C + sigma I)^{-1}`` from the spectrum of C.

    Paper Alg. 3 line 2: ``rho |spec|^2 + sigma`` is real and positive, so
    the inverse is its pointwise reciprocal.  Returned in ``spec``'s
    (complex) dtype with zero imaginary part, as the reference does.
    """
    return (1.0 / (rho * spec.abs() ** 2 + sigma)).to(spec.dtype)
