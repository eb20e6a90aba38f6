"""Public wrappers of the fused soft-threshold kernels, with launch counts."""

from __future__ import annotations

import torch

from .. import on_meta, report_launch, require_cuda_operands
from .ref import admm_threshold_dual_update_ref, ista_step_update_ref, ista_threshold_update_ref


def _scalar_operand(name: str, value, like: torch.Tensor):
    """``value`` as the kernel takes it: a Python number as it is (a kernel
    argument, no fill launch); a one-element tensor as a 1-element float32
    tensor on ``like``'s device, so a value computed there (CPISTA's
    ``tau``) is read by the kernel where it lies."""
    if not isinstance(value, torch.Tensor):
        return float(value)
    if value.numel() != 1:
        raise ValueError(f"{name} must be a scalar or a 1-element tensor; got shape "
                         f"{tuple(value.shape)}")
    return value.to(device=like.device, dtype=torch.float32).reshape(1)


def fused_ista_update(x: torch.Tensor, delta: torch.Tensor, gamma, *, tau=None) -> torch.Tensor:
    """eta_gamma(x + delta), fused; any shape, leading axes being signals.

    With ``tau``: eta_{gamma tau}(x + tau delta), CPISTA's whole update from
    the raw gradient ``delta`` and the l1 weight ``gamma`` (Alg. 8), with
    ``tau * delta`` rounded before the add.  ``gamma`` and ``tau`` are
    numbers or 1-element tensors.  CPU tensors take the plain version; CUDA
    tensors launch the Triton kernel, which needs contiguous float32
    operands and raises otherwise; ``meta`` tensors take the
    shape-propagation route (:mod:`repro_torch.kernels`).
    """
    if x.shape != delta.shape:
        raise ValueError(f"fused_ista_update shapes: x {tuple(x.shape)}, "
                         f"delta {tuple(delta.shape)}")
    if x.device.type == "cpu" and delta.device.type == "cpu":
        if tau is None:
            return ista_threshold_update_ref(x, delta, gamma)
        return ista_step_update_ref(x, delta, tau, gamma)
    require_cuda_operands("soft_threshold", {"x": x, "delta": delta},
                          {"x": torch.float32, "delta": torch.float32})
    gamma = _scalar_operand("gamma", gamma, x)
    tau = None if tau is None else _scalar_operand("tau", tau, x)
    if on_meta(x, delta):
        out = torch.empty_like(x)
    else:
        from .kernel import ista_update

        with torch.cuda.device(x.device):
            out = ista_update(x, delta, gamma, tau)
        fused_ista_update.launches += 1
    report_launch("soft_threshold_ista", x, delta, out,
                  flops=(3 if tau is None else 4) * x.numel())
    return out


fused_ista_update.launches = 0


def fused_admm_update(x: torch.Tensor, nu: torch.Tensor, gamma, tau2):
    """(z, nu') = (eta_gamma(x + nu), nu + tau2 (x - z)), fused; any shape.

    ``gamma`` and ``tau2`` are numbers or 1-element tensors.  CPU tensors
    take the plain version; CUDA tensors launch the Triton kernel, which
    needs contiguous float32 operands and raises otherwise; ``meta`` tensors
    take the shape-propagation route (:mod:`repro_torch.kernels`).
    """
    if x.shape != nu.shape:
        raise ValueError(f"fused_admm_update shapes: x {tuple(x.shape)}, nu {tuple(nu.shape)}")
    if x.device.type == "cpu" and nu.device.type == "cpu":
        return admm_threshold_dual_update_ref(x, nu, gamma, tau2)
    require_cuda_operands("soft_threshold", {"x": x, "nu": nu},
                          {"x": torch.float32, "nu": torch.float32})
    gamma, tau2 = _scalar_operand("gamma", gamma, x), _scalar_operand("tau2", tau2, x)
    if on_meta(x, nu):
        out = (torch.empty_like(x), torch.empty_like(x))
    else:
        from .kernel import admm_update

        with torch.cuda.device(x.device):
            out = admm_update(x, nu, gamma, tau2)
        fused_admm_update.launches += 1
    report_launch("soft_threshold_admm", x, nu, *out, flops=6 * x.numel())
    return out


fused_admm_update.launches = 0
