"""Herschel-style multi-observation map-making on the compressed-deblur stack.

Port of ``repro/core/mapmaking.py``.  A space observatory scans the same
sky patch at small pointing offsets and fuses the dithered exposures into
one map (Herschel/PACS map-making).  Under the paper's compressed-sensing
telescope model each exposure ``f`` observes

    y_f = P (C B) S_{s_f} x           (A_f = A S_{s_f},  A = P (C B))

with ``x`` the sky map, ``S_s`` the pointing offset as a shift circulant
(``S_s v = roll(v, s)`` on the raster), ``B`` the telescope PSF, ``C`` the
sensing circulant and ``P`` the row selector.  Every factor is circulant,
so each frame's operator is the same joint ``A`` applied to a shifted sky:
the whole stack recovers through ONE planned operator with frames as the
batch, then co-adds by unshifting,

    x_hat = mean_f  roll(z_f_hat, -s_f).

The blurred, shifted frames are not sparse point fields: the TV prior
(:class:`repro_torch.ops.prox.TVProx`) is the right regulariser and the
:func:`build_mapmaking_plan` default.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

from ..ops.prox import TVProx
from .circulant import PartialCirculant, shift_circulant
from .deblur import DeblurProblem, build_deblur_plan, build_multiframe_deblur_problem


class MapMakingProblem(NamedTuple):
    """A dithered-exposure stack through one shared compressed optic.

    ``deblur`` carries the joint operator ``A = P (C B)`` and the *shifted*
    frame stack as its image (``deblur.image[f] = roll(sky, shifts[f])`` on
    the raster), so every deblur helper applies to the per-frame recovery
    unchanged.
    """

    deblur: DeblurProblem  # shared optic; image = (F, H, W) shifted skies
    sky: torch.Tensor  # (H, W) ground-truth map
    shifts: Tuple[int, ...]  # per-frame raster offset s_f


def build_mapmaking_problem(
    gen: torch.Generator,
    sky: torch.Tensor,
    shifts: Sequence[int],
    blur_order: float = 3.0,
    subsample: float = 0.5,
    sensing: str = "romberg",
    blur_kind: str = "gaussian",
) -> MapMakingProblem:
    """Observe ``sky`` at each raster offset through one shared optic, on
    ``sky``'s device.

    ``shifts`` are flat-raster offsets (a multiple of the row width W is a
    vertical dither, small values horizontal ones; the raster wraps at row
    edges, as the circulant model does).  The sensing circulant and the row
    subset are drawn from ``gen``, as :func:`build_multiframe_deblur_problem`
    draws them.
    """
    if sky.ndim != 2:
        raise ValueError(
            f"build_mapmaking_problem takes a single (H, W) sky map; got "
            f"shape {tuple(sky.shape)}"
        )
    if len(shifts) == 0:
        raise ValueError("need at least one pointing offset in shifts")
    h, w = sky.shape
    flat = sky.reshape(h * w)
    shifts = tuple(int(s) for s in shifts)
    frames = torch.stack([torch.roll(flat, s).reshape(h, w) for s in shifts])
    dp = build_multiframe_deblur_problem(
        gen, frames, blur_order=blur_order, subsample=subsample,
        sensing=sensing, blur_kind=blur_kind,
    )
    return MapMakingProblem(deblur=dp, sky=sky, shifts=shifts)


def frame_operator(problem: MapMakingProblem, f: int) -> PartialCirculant:
    """The factored per-frame view ``A_f = P (C B S_{s_f})``, sky -> y_f:
    the shared joint circulant composed with the frame's shift circulant
    (spectra multiply).  ``frame_operator(p, f).matvec(sky)`` equals
    ``p.deblur.op.matvec(roll(sky, s_f))``, which is why the batched solve
    shares one planned operator."""
    joint = problem.deblur.op.circ
    shifted = joint.compose(
        shift_circulant(joint.n, problem.shifts[f], dtype=joint.col.dtype,
                        device=joint.col.device)
    )
    return PartialCirculant(shifted, problem.deblur.op.omega)


def build_mapmaking_plan(problem: MapMakingProblem, mesh=None, *, prox="tv", **kw):
    """Lower the shared map-making operator; the TV prior by default.

    Rides :func:`build_deblur_plan` (the same knobs; frames go on a mesh's
    'data' axis when it has one).  ``prox`` takes any prox of
    :mod:`repro_torch.ops.prox`; ``"tv"`` builds a :class:`TVProx` on the
    sky's own grid, and ``None`` is the paper's l1 soft threshold (the kernel
    steps stay eligible).
    """
    if prox == "tv":
        prox = TVProx(shape=tuple(problem.sky.shape))
    return build_deblur_plan(problem.deblur, mesh, prox=prox, **kw)


def coadd(problem: MapMakingProblem, z: torch.Tensor) -> torch.Tensor:
    """Fuse recovered shifted skies (..., F, n) into one (..., H, W) map:
    unshift each frame and average."""
    h, w = problem.sky.shape
    frames = [torch.roll(z[..., f, :], -s, dims=-1) for f, s in enumerate(problem.shifts)]
    return (sum(frames) / len(frames)).reshape(z.shape[:-2] + (h, w))


def mapmaking_metrics(problem: MapMakingProblem, z: torch.Tensor) -> dict:
    """Map-level metrics of the co-added estimate against the true sky.

    ``z`` is the batched solver output (..., F, n).  PSNR references the
    true map's peak intensity, as :func:`deblur_metrics` does.
    """
    x_hat = coadd(problem, z)
    err = problem.sky - x_hat
    mse = (err * err).mean(dim=(-2, -1))
    peak = problem.sky.abs().max()
    safe_peak = torch.where(peak > 0, peak, torch.ones_like(peak))
    psnr = torch.where(
        peak > 0,
        10.0 * torch.log10(safe_peak * safe_peak / (mse + 1e-20)),
        torch.full_like(mse, -math.inf),
    )
    return {"map": x_hat, "mse": mse, "rms": torch.sqrt(mse), "psnr_db": psnr}


def solve_mapmaking(
    problem: MapMakingProblem,
    plan=None,
    method: str = "cpadmm",
    iters: int = 400,
    alpha: float = 1e-4,
    rho: float = 0.01,
    sigma: float = 0.01,
) -> Tuple[torch.Tensor, dict]:
    """End to end: the batched solve of the shifted stack, then the co-add.

    Returns ``(z_hat, metrics)``: the (F, n) recovered shifted skies (on a
    mesh, this rank's frames gathered) and :func:`mapmaking_metrics` (the
    co-added map under ``"map"``).  Builds the default TV plan when none is
    given.
    """
    from .solvers import RecoveryProblem, solve

    if plan is None:
        plan = build_mapmaking_plan(problem)
    n = math.prod(problem.sky.shape)
    x_true = problem.deblur.image.reshape(len(problem.shifts), n)
    prob = RecoveryProblem(op=problem.deblur.op, y=problem.deblur.y, x_true=x_true)
    z_hat, _ = solve(prob, method, iters=iters, alpha=alpha, rho=rho, sigma=sigma, plan=plan)
    if plan.is_distributed:
        z_hat = plan.gather_batch(z_hat)
    return z_hat, mapmaking_metrics(problem, z_hat)
