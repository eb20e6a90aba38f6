"""Shared spectral helpers: the rfft pair and the CPADMM gram inverse.

Port of ``repro/ops/spectral.py``.  Transforms act on the trailing axis
and broadcast over leading batch axes.  On the card they are ``torch.fft``
(cuFFT), as the reference's are XLA's FFT.  ``n2`` / ``p`` in the
half-spectrum helpers are the four-step layout's column count and mesh
size (see :mod:`repro_torch.dist.fft`).
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


def full_from_half(spec_h: torch.Tensor, n: int) -> torch.Tensor:
    """Flat half spectrum (..., n//2 + 1) -> full flat DFT (..., n).

    Hermitian symmetry of a real signal's DFT, ``X[n - k] = conj(X[k])``,
    gives the discarded bins: a conjugate flip and a concatenation, no
    transform.  The flat case of :func:`half_to_full` (a one-row layout).
    """
    return half_to_full(spec_h[..., None, :], n)[..., 0, :]


def spectrum_layout_2d(spec_h: torch.Tensor, n1: int, n2: int, *, rfft: bool = False,
                       p: int = 1) -> torch.Tensor:
    """Flat half spectrum -> the four-step ``(n1, n2)`` spectrum layout.

    The four-step transform produces ``F[k1, k2] = X[n2*k1 + k2]``, a plain
    row-major reshape of the full flat DFT, so an operator whose spectrum is
    stored (the composed sensing+blur of paper Sec. 7) lowers onto a mesh
    with no transform.  ``rfft=True`` returns the half layout: the kept
    columns ``k2 in [0, n2//2]`` zero-padded to a multiple of ``p``.
    """
    F = full_from_half(spec_h, n1 * n2).reshape(spec_h.shape[:-1] + (n1, n2))
    if not rfft:
        return F
    nf = rfft_len(n2)
    return torch.nn.functional.pad(F[..., :nf], (0, padded_rfft_len(n2, p) - nf))


def rfft_len(n2: int) -> int:
    """Kept columns of the half spectrum: k2 in [0, n2//2]."""
    return n2 // 2 + 1


def padded_rfft_len(n2: int, p: int) -> int:
    """Kept columns zero-padded up to a multiple of the mesh size ``p``, so
    the transpose all-to-all splits them evenly on any rank count."""
    return -(-rfft_len(n2) // p) * p


def half_to_full(Fh: torch.Tensor, n2: int) -> torch.Tensor:
    """Half-spectrum layout (..., n1, >=nf) -> full spectrum (..., n1, n2).

    With ``k = n2*k1 + k2`` the symmetry reads
    ``F[k1, k2] = conj(F[n1 - 1 - k1, n2 - k2])`` for ``k2 in [nf, n2)``.
    """
    nf = rfft_len(n2)
    Fh = Fh[..., :nf]
    tail = torch.flip(torch.conj(Fh[..., 1: n2 - nf + 1]), dims=(-2, -1))
    return torch.cat([Fh, tail], dim=-1)
