"""Triton kernel: the CPADMM frequency-domain x-update in one pass.

    X(f) = b(f) * (rho * conj(c(f)) * VM(f) + sigma * ZN(f))

over the half spectrum (``nf = n//2 + 1`` bins), for B signals through one
operator.  Replaces the TPU kernel ``cpadmm_spectral_update``
(``src/repro/kernels/spectral_pointwise/kernel.py``), which splits real
and imaginary planes because Pallas has no complex type.

Bound on the H100: bytes.  Per bin it reads c (8 B) and b (4 B) once for
the whole batch and VM, ZN (8 B each) and writes X (8 B) once per signal —
no reuse, nothing to stage in shared memory, no tensor-core work.  So the
design is one streaming pass: complex64 is read as interleaved float pairs
(``torch.view_as_real``, no plane split), a 1-D grid walks B x ceil(nf /
BLOCK) tiles with the ragged edge masked (nf is odd for even n), and the
operator streams c and b are indexed without the batch stride, so L2
serves them to every signal of the batch.

``triton`` is imported on the first launch, never at import time.
"""

from __future__ import annotations

import torch

BLOCK = 1024
NUM_WARPS = 4

tl = None  # triton.language, bound by _compiled() on the first launch
_jit = None


def _spectral_pointwise(
    c_ptr, b_ptr, vm_ptr, zn_ptr, out_ptr, nf, nblk, rho, sigma, BLOCK: tl.constexpr
):
    pid = tl.program_id(0)
    row = (pid // nblk).to(tl.int64)
    offs = (pid % nblk) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < nf
    re = 2 * offs  # interleaved (re, im) float pairs
    cr = tl.load(c_ptr + re, mask=mask, other=0.0)
    ci = tl.load(c_ptr + re + 1, mask=mask, other=0.0)
    b = tl.load(b_ptr + offs, mask=mask, other=0.0)
    sig = row * (2 * nf) + re
    vr = tl.load(vm_ptr + sig, mask=mask, other=0.0)
    vi = tl.load(vm_ptr + sig + 1, mask=mask, other=0.0)
    zr = tl.load(zn_ptr + sig, mask=mask, other=0.0)
    zi = tl.load(zn_ptr + sig + 1, mask=mask, other=0.0)
    # conj(c) * vm
    tr = cr * vr + ci * vi
    ti = cr * vi - ci * vr
    tl.store(out_ptr + sig, b * (rho * tr + sigma * zr), mask=mask)
    tl.store(out_ptr + sig + 1, b * (rho * ti + sigma * zi), mask=mask)


def _compiled():
    global tl, _jit
    if _jit is None:
        from ..build import import_triton

        triton = import_triton()
        tl = triton.language
        _jit = triton.jit(_spectral_pointwise)
    return _jit


def spectral_pointwise(c, b, vm, zn, rho: float, sigma: float) -> torch.Tensor:
    """Launch on CUDA tensors: c (nf,) complex64, b (nf,) float32,
    vm / zn (B, nf) complex64, all contiguous -> X (B, nf) complex64."""
    bsz, nf = vm.shape
    out = torch.empty_like(vm)
    nblk = -(-nf // BLOCK)
    _compiled()[(bsz * nblk,)](
        torch.view_as_real(c), b, torch.view_as_real(vm), torch.view_as_real(zn),
        torch.view_as_real(out), nf, nblk, float(rho), float(sigma),
        BLOCK=BLOCK, num_warps=NUM_WARPS,
    )
    return out

