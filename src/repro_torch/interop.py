"""Carry the reference's parameters across: numpy arrays -> port objects.

Each function takes numpy arrays (what ``np.asarray`` gives of the
reference's JAX arrays) and a ``device=`` (``None`` = the CUDA default).
Stored spectra are taken as given and never recomputed, so a composed
operator (``spec(C) * spec(B)``, whose column is derived from the product)
is the same operator on both sides.  On a mesh, the carriers take the
reference's *global* arrays and keep this rank's blocks of them.  This
module imports neither JAX nor the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.admm import CpadmmState
from .core.circulant import Circulant, DenseOperator, PartialCirculant
from .core.compression import CompressorState
from .core.deblur import DeblurProblem
from .core.mapmaking import MapMakingProblem
from .device import resolve_device
from .dist.fft import col_block, row_block
from .dist.recovery import DistCpadmmState
from .ops.plan import PlanConfig
from .ops.prox import prox_from_dict

# the reference's tail names -> the port's
_TAILS = {"jnp": "plain", "pallas": "kernel"}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    # a copy: the reference's arrays come back read-only, which torch cannot wrap
    return torch.as_tensor(np.array(a), dtype=dtype, device=resolve_device(device))


def circulant_from_numpy(col, spec, device=None) -> Circulant:
    return Circulant(col=_tensor(col, device), spec=_tensor(spec, device))


def partial_circulant_from_numpy(col, spec, omega, device=None) -> PartialCirculant:
    return PartialCirculant(
        circulant_from_numpy(col, spec, device), _tensor(omega, device, torch.int64)
    )


def dense_operator_from_numpy(mat, device=None) -> DenseOperator:
    """The reference's ``DenseOperator.mat`` (m, n) -> the port's."""
    return DenseOperator(mat=_tensor(mat, device))


def cpadmm_state_from_numpy(x, v, z, mu, nu, device=None) -> CpadmmState:
    return CpadmmState(*(_tensor(a, device) for a in (x, v, z, mu, nu)))


def deblur_problem_from_numpy(
    col, spec, omega, blur_col, blur_spec, y, image, device=None
) -> DeblurProblem:
    return DeblurProblem(
        op=partial_circulant_from_numpy(col, spec, omega, device),
        blur=circulant_from_numpy(blur_col, blur_spec, device),
        y=_tensor(y, device),
        image=_tensor(image, device),
    )


def mapmaking_problem_from_numpy(
    col, spec, omega, blur_col, blur_spec, y, image, sky, shifts, device=None
) -> MapMakingProblem:
    """The reference's ``MapMakingProblem``: its ``deblur`` problem's arrays
    (the shifted frame stack as ``image``), the true ``sky`` and the
    per-frame raster ``shifts``."""
    return MapMakingProblem(
        deblur=deblur_problem_from_numpy(col, spec, omega, blur_col, blur_spec, y, image,
                                         device),
        sky=_tensor(sky, device),
        shifts=tuple(int(s) for s in shifts),
    )


def compressor_state_from_numpy(col, omega, residual, device=None) -> CompressorState:
    """The reference's ``CompressorState`` (its spec is plain numbers, and a
    prox carried by :func:`prox_from_reference_dict`)."""
    return CompressorState(col=_tensor(col, device), omega=_tensor(omega, device, torch.int64),
                           residual=_tensor(residual, device))


def prox_from_reference_dict(d):
    """The reference's ``prox.to_dict()`` -> the port's prox (the same
    kinds and fields)."""
    return prox_from_dict(d)


def plan_config_from_reference_dict(d) -> PlanConfig:
    """The reference's ``PlanConfig.to_dict()`` -> the port's PlanConfig:
    the tail ``jnp`` / ``pallas`` becomes ``plain`` / ``kernel``; the
    hierarchical knobs must be at their defaults
    (:meth:`PlanConfig.from_dict`)."""
    d = dict(d)
    d["tail"] = _TAILS.get(d.get("tail"), d.get("tail"))
    return PlanConfig.from_dict(d)


def plan_parts_from_numpy(spec2d, mask2d, mesh, device=None):
    """The reference's global four-step spectrum (n1, c) and mask (n1, n2)
    -> this rank's (spectrum columns, mask rows), the operands of
    :func:`repro_torch.ops.plan.plan_from_parts`."""
    return (col_block(_tensor(spec2d, device), mesh), row_block(_tensor(mask2d, device), mesh))


def dist_cpadmm_state_from_numpy(x, v, z, mu, nu, plan, device=None):
    """A global (..., n1, n2) CPADMM state -> this rank's blocks under the
    distributed ``plan``: its rows, and its signals when the plan splits
    the batch."""
    return plan.local_state(DistCpadmmState(*(_tensor(a, device) for a in (x, v, z, mu, nu))))


def lm_params_from_numpy(tree, cfg, device=None) -> dict:
    """The reference's LM parameter tree (``np.asarray`` of each leaf of
    ``repro.models.lm.init_params``) -> the port's parameters: the same
    nested dict, ``embed`` / ``final_norm`` / ``segments[i]`` with each
    segment's leaves stacked along the layer axis, every weight in the
    reference's (d_in, d_out) orientation and dtype.  Dense decoder-only
    trees only (``cfg``'s layer kinds must all be 'dense')."""
    extra = sorted(set(tree) - {"embed", "final_norm", "segments"})
    if extra or any(kind != "dense" for kind in cfg.layer_kinds()):
        raise NotImplementedError(
            f"{cfg.name}: only dense decoder-only parameter trees are carried across "
            f"(ROADMAP.md Queue 1 item 11); this one has {extra or set(cfg.layer_kinds())}"
        )

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [carry(v) for v in node]
        return _tensor(node, device)

    return carry({k: tree[k] for k in ("embed", "final_norm", "segments")})
