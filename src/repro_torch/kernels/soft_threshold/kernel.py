"""Triton kernels: the fused soft-threshold updates (paper Eq. 4, Alg. 8).

    ista:  x'  = eta_{alpha tau}(x + tau * delta)     (tau absent: eta_alpha(x + delta))
    admm:  z   = eta_gamma(x + nu),   nu' = nu + tau2 * (x - z)

Replace the TPU kernels ``ista_threshold_update`` and
``admm_threshold_dual_update`` (``src/repro/kernels/soft_threshold/
kernel.py``), which take 1-D operands padded to a multiple of 1024.  The
ista kernel also folds in what CPISTA's step computed before it (Alg. 8:
"the gradient update and the threshold in one kernel"): the step ``tau *
grad`` and the threshold ``alpha * tau``, so a CPISTA step launches two
kernels fewer.  ``tau * delta`` is rounded before the add, as the plain
version rounds it (the kernels are compiled with ``enable_fp_fusion=False``:
no fused multiply-add), which keeps both kernels bit-equal to their plain
versions.

Bound on the H100: bytes.  Each is one elementwise pass with no reuse:
3 streams (ista: x, delta in, x' out) or 4 (admm: x, nu in, z, nu' out),
a few FLOPs per element, nothing for shared memory or the tensor cores.
At the main path's sizes (0.5-3 MB a call) the byte bound is below a
microsecond, the order of what one more kernel costs the stream, so what
the design can move is the launch and the memory round trip:

  * the grid is sized to the card, not to the data: at most a few
    programs on each SM (``CONFIG``'s third entry), each walking the flat range
    with a grid-stride loop of ``BLOCK``-element tiles (contiguous and
    aligned, so Triton issues 16-byte accesses), every SM busy even at
    Path C's 131072 elements;
  * a scalar is a kernel argument when the caller has it on the host (no
    fill launch) and a 1-element device tensor, read in the kernel, when it
    lives on the card (CPISTA's ``tau``), so it never comes back to the
    host;
  * any n and any batch, the ragged edge masked, no padding.

``CONFIG`` is the setting phase 2 of ``chip_smoke.py`` measured fastest of
``SWEEP``.  ``triton`` is imported on the first launch, never at import
time.
"""

from __future__ import annotations

import torch

# (BLOCK, num_warps, programs per SM): the committed setting, then the
# others chip_smoke.py sweeps beside it
CONFIG = (512, 4, 4)
SWEEP = ((512, 4, 4), (1024, 4, 4), (2048, 8, 2), (256, 2, 8))

tl = None  # triton.language, bound by _compiled() on the first launch
_jit = None
_sm_count: dict = {}


def _ista_update(x_ptr, d_ptr, tau, alpha, out_ptr, N, HAS_TAU: tl.constexpr,
                 TAU_PTR: tl.constexpr, ALPHA_PTR: tl.constexpr, BLOCK: tl.constexpr):
    step = tl.num_programs(0).to(tl.int64) * BLOCK
    for start in range(tl.program_id(0).to(tl.int64) * BLOCK, N, step):
        offs = start + tl.arange(0, BLOCK)
        mask = offs < N
        d = tl.load(d_ptr + offs, mask=mask, other=0.0)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0)
        # the scalars are read after the streams' loads are issued, so their
        # latency overlaps them (read before the loop, they delay every load)
        if ALPHA_PTR:
            gamma = tl.load(alpha)
        else:
            gamma = alpha
        if HAS_TAU:
            if TAU_PTR:
                t = tl.load(tau)
            else:
                t = tau
            gamma = gamma * t
            d = t * d
        s = x + d
        # sign(s) * max(|s| - gamma, 0), written as the two shrink branches
        out = tl.where(s > gamma, s - gamma, tl.where(s < -gamma, s + gamma, 0.0))
        tl.store(out_ptr + offs, out, mask=mask)


def _admm_update(x_ptr, nu_ptr, gamma, tau2, z_ptr, nu_out_ptr, N,
                 GAMMA_PTR: tl.constexpr, TAU2_PTR: tl.constexpr, BLOCK: tl.constexpr):
    step = tl.num_programs(0).to(tl.int64) * BLOCK
    for start in range(tl.program_id(0).to(tl.int64) * BLOCK, N, step):
        offs = start + tl.arange(0, BLOCK)
        mask = offs < N
        x = tl.load(x_ptr + offs, mask=mask, other=0.0)
        nu = tl.load(nu_ptr + offs, mask=mask, other=0.0)
        if GAMMA_PTR:
            g = tl.load(gamma)
        else:
            g = gamma
        if TAU2_PTR:
            t2 = tl.load(tau2)
        else:
            t2 = tau2
        s = x + nu
        z = tl.where(s > g, s - g, tl.where(s < -g, s + g, 0.0))
        tl.store(z_ptr + offs, z, mask=mask)
        tl.store(nu_out_ptr + offs, nu + t2 * (x - z), mask=mask)


def _compiled():
    global tl, _jit
    if _jit is None:
        from ..build import import_triton

        triton = import_triton()
        tl = triton.language
        _jit = (triton.jit(_ista_update), triton.jit(_admm_update))
    return _jit


def _grid(n_elems: int, device: torch.device, block: int, per_sm: int) -> tuple:
    """As many programs as the tiles need, at most ``per_sm`` on each SM."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return (max(1, min(-(-n_elems // block), per_sm * _sm_count[device])),)


def _scalar(v):
    """(kernel argument, is a device pointer): a 1-element tensor is read in
    the kernel, a number passed by value."""
    return (v, True) if isinstance(v, torch.Tensor) else (float(v), False)


def ista_update(x, delta, alpha, tau=None, config=None) -> torch.Tensor:
    """Launch on contiguous float32 CUDA tensors of one shape: ->
    eta_{alpha tau}(x + tau delta), or eta_alpha(x + delta) without ``tau``.
    ``alpha`` and ``tau`` are numbers or 1-element float32 tensors on x's
    device; ``config`` overrides :data:`CONFIG`."""
    block, warps, per_sm = config or CONFIG
    out = torch.empty_like(x)
    a, a_ptr = _scalar(alpha)
    t, t_ptr = _scalar(1.0 if tau is None else tau)
    _compiled()[0][_grid(x.numel(), x.device, block, per_sm)](
        x, delta, t, a, out, x.numel(), HAS_TAU=tau is not None, TAU_PTR=t_ptr,
        ALPHA_PTR=a_ptr, BLOCK=block, num_warps=warps, enable_fp_fusion=False,
    )
    return out


def admm_update(x, nu, gamma, tau2, config=None):
    """Launch on contiguous float32 CUDA tensors of one shape: -> (z, nu').
    ``gamma`` and ``tau2`` are numbers or 1-element float32 tensors on x's
    device; ``config`` overrides :data:`CONFIG`."""
    block, warps, per_sm = config or CONFIG
    z, nu_out = torch.empty_like(x), torch.empty_like(x)
    g, g_ptr = _scalar(gamma)
    t2, t2_ptr = _scalar(tau2)
    _compiled()[1][_grid(x.numel(), x.device, block, per_sm)](
        x, nu, g, t2, z, nu_out, x.numel(), GAMMA_PTR=g_ptr, TAU2_PTR=t2_ptr, BLOCK=block,
        num_warps=warps, enable_fp_fusion=False,
    )
    return z, nu_out
