"""Public wrapper of the fused CPADMM tail, with its launch count."""

from __future__ import annotations

import math

import torch

from .. import on_meta, report_launch, require_cuda_operands
from .ref import cpadmm_tail_ref


def fused_cpadmm_tail(x, cx, d_diag, pty, mu, nu, rho, gamma, tau1, tau2):
    """(v, z, mu', nu') = the fused Alg. 3 tail; shapes follow ``x``.

    ``d_diag`` defines the signal shape S; ``x``, ``cx``, ``mu``, ``nu`` are
    ``batch + S``; ``pty`` is S (one P^T y shared by the batch) or
    ``batch + S`` (per signal).  ``gamma`` is alpha / sigma.  CPU tensors
    take the plain version; CUDA tensors launch the Triton kernel, which
    needs contiguous float32 inputs and raises otherwise; ``meta`` tensors
    take the shape-propagation route (:mod:`repro_torch.kernels`).
    """
    sig_shape = d_diag.shape
    batch = x.shape[: x.ndim - len(sig_shape)]
    streams = {"x": x, "cx": cx, "mu": mu, "nu": nu}
    if x.shape[len(batch):] != sig_shape or any(t.shape != x.shape for t in streams.values()) \
            or pty.shape not in (sig_shape, x.shape):
        raise ValueError(
            f"cpadmm tail shapes: d {tuple(sig_shape)}, pty {tuple(pty.shape)}, "
            + ", ".join(f"{k} {tuple(t.shape)}" for k, t in streams.items())
        )
    tensors = {"d_diag": d_diag, "pty": pty, **streams}
    if all(t.device.type == "cpu" for t in tensors.values()):
        return cpadmm_tail_ref(x, cx, d_diag, pty, mu, nu, rho, gamma, tau1, tau2)
    require_cuda_operands("cpadmm_tail", tensors, dict.fromkeys(tensors, torch.float32))
    L = math.prod(sig_shape)
    flat = lambda t: t.reshape(-1, L)
    if on_meta(*tensors.values()):
        outs = tuple(torch.empty(flat(x).shape, device="meta") for _ in range(4))
    else:
        from .kernel import cpadmm_tail

        with torch.cuda.device(x.device):
            outs = cpadmm_tail(
                d_diag.reshape(L), flat(pty) if pty.shape == x.shape and batch else pty.reshape(L),
                flat(x), flat(cx), flat(mu), flat(nu), rho, gamma, tau1, tau2,
            )
        fused_cpadmm_tail.launches += 1
    report_launch("cpadmm_tail", d_diag, pty, x, cx, mu, nu, *outs, flops=12 * x.numel())
    return tuple(o.reshape(x.shape) for o in outs)


fused_cpadmm_tail.launches = 0
