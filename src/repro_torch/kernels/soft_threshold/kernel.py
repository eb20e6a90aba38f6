"""Triton kernels: the fused soft-threshold updates (paper Eq. 4, Alg. 8).

    ista:  x'  = eta_gamma(x + delta)
    admm:  z   = eta_gamma(x + nu),   nu' = nu + tau2 * (x - z)

Replace the TPU kernels ``ista_threshold_update`` and
``admm_threshold_dual_update`` (``src/repro/kernels/soft_threshold/
kernel.py``), which take 1-D operands padded to a multiple of 1024.

Bound on the H100: bytes.  Each is one elementwise pass with no reuse:
3 streams (ista: x, delta in, x' out) or 4 (admm: x, nu in, z, nu' out),
a few FLOPs per element, nothing for shared memory or the tensor cores.
So the design is one streaming pass over a 1-D grid that covers all
``batch * n`` elements with the ragged edge masked — any n and any batch,
no padding.  ``gamma`` and ``tau2`` are read from 1-element device tensors
(as the Pallas kernel reads ``gamma_ref[0]``), so a threshold computed on
the card (``alpha * tau``) never has to come back to the host.

``triton`` is imported on the first launch, never at import time.
"""

from __future__ import annotations

import torch

BLOCK = 1024
NUM_WARPS = 4

tl = None  # triton.language, bound by _compiled() on the first launch
_jit = None


def _ista_update(x_ptr, d_ptr, gamma_ptr, out_ptr, N, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    gamma = tl.load(gamma_ptr)
    s = tl.load(x_ptr + offs, mask=mask, other=0.0) + tl.load(d_ptr + offs, mask=mask, other=0.0)
    # sign(s) * max(|s| - gamma, 0), written as the two shrink branches
    out = tl.where(s > gamma, s - gamma, tl.where(s < -gamma, s + gamma, 0.0))
    tl.store(out_ptr + offs, out, mask=mask)


def _admm_update(x_ptr, nu_ptr, gamma_ptr, tau2_ptr, z_ptr, nu_out_ptr, N,
                 BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    gamma = tl.load(gamma_ptr)
    tau2 = tl.load(tau2_ptr)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    nu = tl.load(nu_ptr + offs, mask=mask, other=0.0)
    s = x + nu
    z = tl.where(s > gamma, s - gamma, tl.where(s < -gamma, s + gamma, 0.0))
    tl.store(z_ptr + offs, z, mask=mask)
    tl.store(nu_out_ptr + offs, nu + tau2 * (x - z), mask=mask)


def _compiled():
    global tl, _jit
    if _jit is None:
        from ..build import import_triton

        triton = import_triton()
        tl = triton.language
        _jit = (triton.jit(_ista_update), triton.jit(_admm_update))
    return _jit


def ista_update(x, delta, gamma) -> torch.Tensor:
    """Launch on contiguous float32 CUDA tensors: x, delta of one shape,
    gamma of one element -> eta_gamma(x + delta), shaped like x."""
    out = torch.empty_like(x)
    N = x.numel()
    _compiled()[0][(-(-N // BLOCK),)](x, delta, gamma, out, N, BLOCK=BLOCK,
                                      num_warps=NUM_WARPS)
    return out


def admm_update(x, nu, gamma, tau2):
    """Launch on contiguous float32 CUDA tensors: x, nu of one shape, gamma
    and tau2 of one element each -> (z, nu'), shaped like x."""
    z, nu_out = torch.empty_like(x), torch.empty_like(x)
    N = x.numel()
    _compiled()[1][(-(-N // BLOCK),)](x, nu, gamma, tau2, z, nu_out, N, BLOCK=BLOCK,
                                      num_warps=NUM_WARPS)
    return z, nu_out
