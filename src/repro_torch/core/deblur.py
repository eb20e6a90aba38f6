"""Compressed image deblurring (paper Sec. 7).

Port of ``repro/core/deblur.py``.  Blur is a circulant convolution ``B``
(the paper's order-L raster moving average, or a gaussian / Airy PSF);
sensing is a circulant ``C``; the joint operator ``A = P C B`` is still
partial circulant, so one CPADMM/CPISTA solve undoes sub-sampling and blur
together.  A (F, H, W) frame stack goes through one shared operator and
one batched solve.  The paper's frame is the 1024x1024 Abell-2744 Hubble
image; ``repro_torch.data.synthetic.starfield`` stands in for it.
``build_deblur_plan`` lowers the joint operator to one device or, with a
mesh, to the four-step transforms of :mod:`repro_torch.dist`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..dist.compat import MODEL_AXIS, Mesh
from ..ops.plan import plan as _plan
from .circulant import (
    Circulant,
    PartialCirculant,
    airy_blur,
    compose_sensing_blur,
    gaussian_blur,
    gaussian_circulant,
    moving_average_blur,
    random_omega,
    romberg_circulant,
)

BLUR_KINDS = ("moving-average", "gaussian", "airy")


def _make_blur(n: int, kind: str, order: float, dtype, device) -> Circulant:
    """PSF family by name; ``order`` is its width: the raster length L
    (moving-average), the std-dev sigma (gaussian) or the first-null radius
    (airy), in pixels."""
    if kind == "moving-average":
        return moving_average_blur(n, int(order), dtype=dtype, device=device)
    if kind == "gaussian":
        return gaussian_blur(n, float(order), dtype=dtype, device=device)
    if kind == "airy":
        return airy_blur(n, float(order), dtype=dtype, device=device)
    raise ValueError(f"blur_kind must be one of {BLUR_KINDS}, got {kind!r}")


class DeblurProblem(NamedTuple):
    op: PartialCirculant  # A = P (C B): the joint sensing+blur operator
    blur: Circulant  # B alone (for rendering the blurred observation)
    y: torch.Tensor  # (..., m) compressed measurements of the *blurred* image(s)
    image: torch.Tensor  # (..., H, W) ground truth (metrics/rendering only)


def build_deblur_problem(
    gen: torch.Generator,
    image: torch.Tensor,
    blur_order: float = 5,
    subsample: float = 0.5,
    sensing: str = "gaussian",
    blur_kind: str = "moving-average",
) -> DeblurProblem:
    """Paper Sec. 7 setup on ``image``'s device: L=5 raster blur, m = n/2.

    ``sensing='gaussian'`` is paper-faithful; ``'romberg'`` is the
    beyond-paper well-conditioned variant.  The sensing circulant and then
    the row subset are drawn from ``gen``.
    """
    if image.ndim != 2:
        raise ValueError(
            f"build_deblur_problem takes a single (H, W) image; got shape "
            f"{tuple(image.shape)} — for a frame stack use "
            f"build_multiframe_deblur_problem"
        )
    h, w = image.shape
    n = h * w
    m = int(round(n * subsample))
    x = image.reshape(n)
    dev = x.device
    make = gaussian_circulant if sensing == "gaussian" else romberg_circulant
    sense = make(gen, n, dtype=x.dtype, device=dev)
    blur = _make_blur(n, blur_kind, blur_order, x.dtype, dev)
    op = PartialCirculant(compose_sensing_blur(sense, blur), random_omega(gen, n, m, device=dev))
    return DeblurProblem(op=op, blur=blur, y=op.matvec(x), image=image)


def build_multiframe_deblur_problem(
    gen: torch.Generator,
    images: torch.Tensor,
    blur_order: float = 5,
    subsample: float = 0.5,
    sensing: str = "gaussian",
    blur_kind: str = "moving-average",
) -> DeblurProblem:
    """Sec. 7 setup for a (F, H, W) frame stack through ONE shared optic:
    ``y`` is (F, m) and one batched solve recovers the whole stack."""
    if images.ndim < 3:
        raise ValueError(
            f"build_multiframe_deblur_problem takes a (..., F, H, W)-like "
            f"frame stack (ndim >= 3); got shape {tuple(images.shape)} — for "
            f"a single image use build_deblur_problem"
        )
    single = build_deblur_problem(
        gen, images.reshape(-1, *images.shape[-2:])[0],
        blur_order=blur_order, subsample=subsample, sensing=sensing, blur_kind=blur_kind,
    )
    x = images.reshape(images.shape[:-2] + (-1,))
    return DeblurProblem(op=single.op, blur=single.blur, y=single.op.matvec(x), image=images)


def build_deblur_plan(problem: DeblurProblem, mesh=None, *, tune=False, batch=None, n1=None,
                      n2=None, rfft=None, overlap=None, tail=None, fused=None, batch_axis=None,
                      axis_name=None, wire_dtype=None, prox=None):
    """Lower the joint operator ``A = P (C B)`` to a backend.

    With ``mesh=None`` the identity lowering; with a mesh, the composed
    spectrum ``spec(C)·spec(B)`` stored on the operator is laid out into
    this rank's spectrum columns once (no time-domain round trip).  The
    keyword defaults are deblur-aware, as the reference's: the four-step
    ``n1 x n2`` is the image's own (H, W) grid whenever it splits over the
    mesh axis, and a frame stack goes on the mesh's ``data`` axis when it
    has one.  ``tail=None`` resolves from the operands' device
    (:func:`repro_torch.ops.plan.resolve_tail`): the kernels on the card.

    ``tune=True`` / ``tune="measure"`` leaves the choice to the plan
    autotuner (:mod:`repro_torch.ops.tune`): the knobs passed become pins,
    the frame stack sizes the tuning batch, and the image's (H, W) grid is
    offered as an extra candidate factorization.
    """
    knobs = dict(rfft=rfft, overlap=overlap, tail=tail, fused=fused, wire_dtype=wire_dtype,
                 prox=prox)
    if mesh is None and not tune:
        # the single validation site rejects distributed-only knobs without a mesh
        return _plan(problem.op, batch_axis=batch_axis, **knobs)
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.dist.compat.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    frames = problem.image.ndim > 2
    h, w = problem.image.shape[-2:]
    if tune:
        if batch is None and frames:
            batch = math.prod(problem.image.shape[:-2])
        return _plan(problem.op, mesh, tune=tune, batch=batch,
                     tune_opts={"extra_factorizations": [(h, w)]}, n1=n1, n2=n2,
                     batch_axis=batch_axis, axis_name=axis_name, **knobs)
    if n1 is None and n2 is None:
        p = mesh.size(axis_name if axis_name is not None else MODEL_AXIS)
        if h % p == 0 and (rfft or w % p == 0):
            n1, n2 = h, w
    if batch_axis is None and frames and "data" in mesh.axis_names and axis_name != "data":
        batch_axis = "data"
    return _plan(problem.op, mesh, n1=n1, n2=n2, batch_axis=batch_axis, axis_name=axis_name,
                 **knobs)


def blurred_observation(problem: DeblurProblem) -> torch.Tensor:
    """The Fig. 9(b) rendering: B x reshaped to the image grid(s)."""
    shape = problem.image.shape
    flat = problem.image.reshape(shape[:-2] + (-1,))
    return problem.blur.matvec(flat).reshape(shape)


def recovered_image(problem: DeblurProblem, x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + problem.image.shape[-2:])


def deblur_metrics(problem: DeblurProblem, x: torch.Tensor) -> dict:
    """Paper Sec. 7 metrics + PSNR, per frame over leading batch axes.

    PSNR uses the ground-truth peak per frame; an all-zero frame has no peak
    to reference, so its PSNR is the ``-inf`` sentinel.
    """
    shape = problem.image.shape
    truth = problem.image.reshape(shape[:-2] + (-1,))
    err = truth - x
    mse = (err * err).mean(dim=-1)
    scale = (truth * truth).mean(dim=-1) + 1e-12
    mean_int = truth.mean(dim=-1) + 1e-12
    peak = truth.abs().amax(dim=-1)
    safe_peak = torch.where(peak > 0, peak, torch.ones_like(peak))  # keep log10 NaN-free
    psnr = torch.where(
        peak > 0,
        10.0 * torch.log10(safe_peak * safe_peak / (mse + 1e-20)),
        torch.full_like(peak, -math.inf),
    )
    return {
        "mse": mse,
        "normalized_mse": mse / scale,
        "mean_abs_err_over_mean_intensity": err.abs().mean(dim=-1) / mean_int,
        "psnr_db": psnr,
    }
