"""Triton kernel: the whole CPADMM iteration tail in one pass.

    v   = d * (pty + rho * (cx - mu))
    z   = eta_gamma(x + nu)
    mu' = mu + tau1 * (v - cx)
    nu' = nu + tau2 * (x - z)

Replaces the TPU kernel ``cpadmm_tail_pallas``
(``src/repro/kernels/cpadmm_tail/kernel.py``).

Bound on the H100: bytes.  Six streams in and four out, elementwise, a few
FLOPs per element: 4L (d) + 4L or 4BL (pty) + 16BL in and 16BL out.  The
design is one streaming pass over a 1-D grid of B x ceil(L / BLOCK) tiles
with the ragged edge masked; v and z live only in registers; the operator
stream d (and pty when one P^T y is shared by the batch) is indexed
without the batch stride, so L2 serves it to every signal.

``triton`` is imported on the first launch, never at import time.
"""

from __future__ import annotations

import torch

BLOCK = 1024
NUM_WARPS = 4

tl = None  # triton.language, bound by _compiled() on the first launch
_jit = None


def _cpadmm_tail(
    d_ptr, pty_ptr, x_ptr, cx_ptr, mu_ptr, nu_ptr,
    v_ptr, z_ptr, mu_out_ptr, nu_out_ptr,
    L, nblk, pty_stride, rho, gamma, tau1, tau2,
    BLOCK: tl.constexpr,
):
    pid = tl.program_id(0)
    row = (pid // nblk).to(tl.int64)
    offs = (pid % nblk) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < L
    sig = row * L + offs
    d = tl.load(d_ptr + offs, mask=mask, other=0.0)
    pty = tl.load(pty_ptr + row * pty_stride + offs, mask=mask, other=0.0)
    x = tl.load(x_ptr + sig, mask=mask, other=0.0)
    cx = tl.load(cx_ptr + sig, mask=mask, other=0.0)
    mu = tl.load(mu_ptr + sig, mask=mask, other=0.0)
    nu = tl.load(nu_ptr + sig, mask=mask, other=0.0)
    v = d * (pty + rho * (cx - mu))
    s = x + nu
    # sign(s) * max(|s| - gamma, 0), written as the two shrink branches
    z = tl.where(s > gamma, s - gamma, tl.where(s < -gamma, s + gamma, 0.0))
    tl.store(v_ptr + sig, v, mask=mask)
    tl.store(z_ptr + sig, z, mask=mask)
    tl.store(mu_out_ptr + sig, mu + tau1 * (v - cx), mask=mask)
    tl.store(nu_out_ptr + sig, nu + tau2 * (x - z), mask=mask)


def _compiled():
    global tl, _jit
    if _jit is None:
        from ..build import import_triton

        triton = import_triton()
        tl = triton.language
        _jit = triton.jit(_cpadmm_tail)
    return _jit


def cpadmm_tail(d, pty, x, cx, mu, nu, rho, gamma, tau1, tau2):
    """Launch on contiguous float32 CUDA tensors: d (L,), pty (L,) or (B, L),
    x / cx / mu / nu (B, L) -> (v, z, mu', nu'), each (B, L)."""
    bsz, L = x.shape
    outs = [torch.empty_like(x) for _ in range(4)]
    nblk = -(-L // BLOCK)
    _compiled()[(bsz * nblk,)](
        d, pty, x, cx, mu, nu, *outs,
        L, nblk, L if pty.ndim == 2 else 0,
        float(rho), float(gamma), float(tau1), float(tau2),
        BLOCK=BLOCK, num_warps=NUM_WARPS,
    )
    return tuple(outs)
