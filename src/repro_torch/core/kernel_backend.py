"""Kernel-backed solver steps: the ports of ``ista_step_pallas`` and
``cpadmm_step_pallas`` (``repro/core/kernel_backend.py``), and a dense
ADMM step the reference does not have.

Same step math as :func:`repro_torch.core.ista.ista_step`,
:func:`repro_torch.core.admm.cpadmm_step` and
:func:`repro_torch.core.admm.dense_admm_step`; only the substrate changes.
CPISTA (paper Alg. 1 with Algs. 7-8):

  * C x and C^T r             -> kernels.circulant_matvec, dispatched on n
  * step, threshold, update   -> kernels.soft_threshold (Triton): one kernel
                                 from the raw gradient, tau * grad and
                                 alpha * tau folded in

CPADMM:

  * frequency-domain x-update -> kernels.spectral_pointwise (Triton),
    between two rffts and one irfft (``torch.fft``, cuFFT on the card)
  * C x                       -> kernels.circulant_matvec: the direct CUDA
                                 kernel below FFT_CROSSOVER (n % 128 == 0),
                                 the FFT path from there on
  * whole elementwise tail    -> kernels.cpadmm_tail (Triton)

Dense ADMM (paper Alg. 2, the PADMM baseline):

  * x-update                  -> torch.matmul with the n x n inverse, as the
                                 reference leaves its einsum to XLA
  * z- and u-updates          -> kernels.soft_threshold's ADMM kernel with
                                 tau2 = 1 (Alg. 2 lines 5-6)

All three are routed from ``make_stepper`` by ``plan(op, tail="kernel")``
with the l1 prior; ``plan(op)`` takes the kernel tail by itself for a
PartialCirculant whose tensors lie on a CUDA device.
"""

from __future__ import annotations

import torch

from ..kernels.circulant_matvec.ops import circulant_matvec
from ..kernels.cpadmm_tail.ops import fused_cpadmm_tail
from ..kernels.soft_threshold.ops import fused_admm_update, fused_ista_update
from ..kernels.spectral_pointwise.ops import spectral_update
from .admm import CpadmmConst, CpadmmParams, CpadmmState, DenseAdmmConst, DenseAdmmState
from .circulant import PartialCirculant
from .ista import IstaParams, IstaState


def ista_step_kernel(
    op: PartialCirculant, y: torch.Tensor, state: IstaState, p: IstaParams
) -> IstaState:
    """CPISTA iteration on the kernel substrate (Algs. 7-8)."""
    col = op.circ.col
    cx = circulant_matvec(col, state.x)
    rt = op.project_back(y - cx[..., op.omega])  # P^T (y - P C x)
    grad = circulant_matvec(col, rt, transpose=True)
    x_new = fused_ista_update(state.x, grad, p.alpha, tau=p.tau)
    return IstaState(x=x_new, x_prev=state.x, t_mom=state.t_mom)


def cpadmm_step_kernel(
    op: PartialCirculant, const: CpadmmConst, state: CpadmmState, p: CpadmmParams
) -> CpadmmState:
    """CPADMM iteration: spectral_pointwise x-update + matvec + one fused tail."""
    n = op.n
    vm = torch.fft.rfft(state.v + state.mu, dim=-1)
    zn = torch.fft.rfft(state.z - state.nu, dim=-1)
    x_spec = spectral_update(op.circ.spec, const.b_spec, vm, zn, p.rho, p.sigma)
    x = torch.fft.irfft(x_spec, n=n, dim=-1)

    cx = circulant_matvec(op.circ.col, x)
    v, z, mu, nu = fused_cpadmm_tail(
        x, cx, const.d_diag, const.Pty, state.mu, state.nu,
        p.rho, p.alpha / p.sigma, p.tau1, p.tau2,
    )
    return CpadmmState(x=x, v=v, z=z, mu=mu, nu=nu)


def dense_admm_step_kernel(
    const: DenseAdmmConst, state: DenseAdmmState, alpha: float, rho: float
) -> DenseAdmmState:
    """Dense ADMM iteration: the x-update's n x n product, then Alg. 2
    lines 5-6 in one kernel: z = eta(x + u), u' = u + (x - z)."""
    x = torch.matmul(const.Aty + rho * (state.z - state.u), const.B.mT)
    z, u = fused_admm_update(x, state.u, alpha / rho, 1.0)
    return DenseAdmmState(x=x, z=z, u=u)
