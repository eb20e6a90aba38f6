"""Plain PyTorch version of the fused CPADMM spectral update."""

from __future__ import annotations


def cpadmm_spectral_update_ref(c_spec, b_spec, vm_spec, zn_spec, rho, sigma):
    """X = b * (rho * conj(c) * VM + sigma * ZN); ``b_spec`` is real."""
    return b_spec * (rho * c_spec.conj() * vm_spec + sigma * zn_spec)
