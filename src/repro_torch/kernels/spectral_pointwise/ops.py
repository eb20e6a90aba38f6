"""Public wrapper of the fused CPADMM spectral update, with its launch count."""

from __future__ import annotations

import torch

from .. import on_meta, report_launch, require_cuda_operands
from .ref import cpadmm_spectral_update_ref


def spectral_update(c_spec, b_spec, vm_spec, zn_spec, rho, sigma) -> torch.Tensor:
    """X = b * (rho * conj(c) * VM + sigma * ZN) over the half spectrum.

    ``c_spec`` (complex) and ``b_spec`` (real) are the shared operator
    spectra of length nf (any half-spectrum length); ``vm_spec`` /
    ``zn_spec`` are (..., nf) complex, leading axes being signals.  CPU
    tensors take the plain version; CUDA tensors launch the Triton kernel,
    which needs complex64 / float32 contiguous inputs and raises otherwise;
    ``meta`` tensors take the shape-propagation route (:mod:`repro_torch.kernels`).
    """
    nf = c_spec.shape[-1]
    if (c_spec.shape, b_spec.shape) != ((nf,), (nf,)) or vm_spec.shape != zn_spec.shape \
            or vm_spec.shape[-1] != nf:
        raise ValueError(
            f"spectral_update shapes: c {tuple(c_spec.shape)}, b {tuple(b_spec.shape)}, "
            f"vm {tuple(vm_spec.shape)}, zn {tuple(zn_spec.shape)}"
        )
    if b_spec.is_complex():
        raise ValueError("b_spec is the real spectrum of B; pass b_spec.real")
    tensors = {"c_spec": c_spec, "b_spec": b_spec, "vm_spec": vm_spec, "zn_spec": zn_spec}
    if all(t.device.type == "cpu" for t in tensors.values()):
        return cpadmm_spectral_update_ref(c_spec, b_spec, vm_spec, zn_spec, rho, sigma)
    dtypes = dict.fromkeys(tensors, torch.complex64)
    dtypes["b_spec"] = torch.float32
    require_cuda_operands("spectral_pointwise", tensors, dtypes)
    batch = vm_spec.shape[:-1]
    if on_meta(*tensors.values()):
        out = torch.empty((vm_spec.numel() // nf, nf), dtype=torch.complex64, device="meta")
    else:
        from .kernel import spectral_pointwise

        with torch.cuda.device(vm_spec.device):
            out = spectral_pointwise(
                c_spec, b_spec, vm_spec.reshape(-1, nf), zn_spec.reshape(-1, nf), rho, sigma
            )
        spectral_update.launches += 1
    report_launch("spectral_pointwise", c_spec, b_spec, vm_spec, zn_spec, out,
                  flops=12 * vm_spec.numel())
    return out.reshape(batch + (nf,))


spectral_update.launches = 0
