"""Plain PyTorch versions of the circulant matvec (held against the kernel)."""

from __future__ import annotations

import torch


def circulant_dense(col: torch.Tensor) -> torch.Tensor:
    """C[i, j] = col[(i - j) mod n], materialized (O(n^2) memory)."""
    n = col.shape[-1]
    i = torch.arange(n, device=col.device)
    return col[(i[:, None] - i[None, :]) % n]


def circulant_matvec_ref(col: torch.Tensor, x: torch.Tensor, *, transpose: bool = False):
    """O(n^2) dense oracle: y = C @ x (or C^T @ x), batched over x's leading axes."""
    C = circulant_dense(col)
    return x @ (C if transpose else C.T)


def circulant_matvec_fft(col: torch.Tensor, x: torch.Tensor, *, transpose: bool = False):
    """O(n log n) convolution-theorem path (the dispatch's other branch)."""
    n = col.shape[-1]
    spec = torch.fft.rfft(col)
    if transpose:
        spec = spec.conj()
    return torch.fft.irfft(spec * torch.fft.rfft(x, n=n), n=n)
