"""CPADMM step functions (paper Alg. 3) over the distributed four-step FFT.

Port of ``repro/dist/recovery.py``: the per-iteration math of distributed
CPADMM on this rank's blocks, and nothing else.  The drivers are
``repro_torch.core.solvers``'s, reached through an execution plan
(``repro_torch.ops.plan.plan(op, mesh)``), which is also how distributed
CPISTA/FISTA run.  Each rank holds

    spectra  (spec of C, spec of B)        its columns  (n1, c/p)
    iterates (x, v, z, mu, nu), d_diag,
    P^T y                                  its rows     (..., n1/p, n2)

B = (rho C^T C + sigma I)^{-1} stays a pointwise reciprocal on the local
spectrum columns, so every cross-rank byte is a transpose all-to-all.

    dist_cpadmm_step        paper-faithful: three circulant applies, six
                            transforms = six all-to-alls per iteration.
    dist_cpadmm_step_fused  the x-update formed in the frequency domain (B
                            and C^T fuse into one local multiply), the two
                            forward and the two inverse transforms each
                            stacked into one: two all-to-alls per iteration.

``rfft=True`` runs both on the half-spectrum transforms; ``hier=True`` on
a (host, device) ``axis_name`` runs every transpose as the two-stage
hierarchical exchange (``inter_wire_dtype`` on its inter-host hops).  ``tail='kernel'``
with the l1 prior runs the elementwise tail as the fused Triton
``cpadmm_tail`` on the local blocks; the frequency-domain x-update stays
plain tensor code, as the reference keeps it in jnp.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from ..core.admm import cpadmm_tail
from ..ops.prox import is_l1
from .compat import MODEL_AXIS
from .fft import fft2_local, ifft2_local, irfft2_local, layout_2d, rfft2_local, unlayout_2d


def _transforms(rfft: bool, n2: int, cdtype, mesh, axis_name, overlap: int = 1,
                wire_dtype: str = "fp32", hier: bool = False, inter_wire_dtype: str = "fp32"):
    """(forward, inverse) pair: real row block <-> spectrum column block."""
    kw = dict(overlap=overlap, wire_dtype=wire_dtype, hier=hier,
              inter_wire_dtype=inter_wire_dtype)
    if rfft:
        fwd = lambda r: rfft2_local(r, mesh, axis_name, **kw)
        inv = lambda F2: irfft2_local(F2, n2, mesh, axis_name, **kw)
    else:
        fwd = lambda r: fft2_local(r.to(cdtype), mesh, axis_name, **kw)
        inv = lambda F2: ifft2_local(F2, mesh, axis_name, **kw).real
    return fwd, inv


def _tail(tail: str, prox=None):
    """The elementwise tail: the fused Triton kernel (``tail='kernel'`` with
    the l1 prior) or the plain tensor code of ``core.admm.cpadmm_tail``.

    The transforms hand back strided views (the real part of a complex
    inverse), and the kernel takes contiguous operands, so the kernel path
    makes them contiguous first.
    """
    if tail not in ("plain", "kernel"):
        raise ValueError(f"tail must be 'plain' or 'kernel', got {tail!r}")
    if tail == "kernel" and is_l1(prox):
        from ..kernels.cpadmm_tail.ops import fused_cpadmm_tail

        def run(x, cx, d_diag, pty, mu, nu, p):
            return fused_cpadmm_tail(
                x.contiguous(), cx.contiguous(), d_diag, pty, mu, nu,
                p.rho, p.alpha / p.sigma, p.tau1, p.tau2,
            )

        return run

    def run(x, cx, d_diag, pty, mu, nu, p):
        return cpadmm_tail(x, cx, d_diag, pty, mu, nu, p, prox=prox)

    return run


class DistCpadmmParams(NamedTuple):
    """Alg. 3 hyperparameters (as ``core.admm.CpadmmParams``)."""

    alpha: float
    rho: float
    sigma: float
    tau1: float
    tau2: float


class DistCpadmmState(NamedTuple):
    """This rank's rows of the iterates, in the (..., n1/p, n2) layout."""

    x: torch.Tensor  # primal estimate
    v: torch.Tensor  # splitting variable, v ~= C x
    z: torch.Tensor  # l1 auxiliary (the recovered signal)
    mu: torch.Tensor  # scaled dual for v = C x
    nu: torch.Tensor  # scaled dual for z = x


def dist_cpadmm_step(spec, b_spec, d_diag, pty, state: DistCpadmmState, p: DistCpadmmParams,
                     mesh, axis_name=MODEL_AXIS, rfft: bool = False, overlap: int = 1,
                     tail: str = "plain", wire_dtype: str = "fp32", prox=None,
                     hier: bool = False, inter_wire_dtype: str = "fp32") -> DistCpadmmState:
    """One paper-faithful Alg. 3 iteration on this rank's blocks.

    spec / b_spec: the spectrum columns of C and B (half layout when
    ``rfft``); d_diag, pty: rows of (P^T P + rho I)^{-1}'s diagonal and of
    P^T y.  Mirrors ``core.admm.cpadmm_step`` line for line.
    """
    fwd, inv = _transforms(rfft, state.x.shape[-1], spec.dtype, mesh, axis_name, overlap,
                           wire_dtype, hier, inter_wire_dtype)
    apply = lambda s, r: inv(s * fwd(r))
    rhs = p.rho * apply(spec.conj(), state.v + state.mu) + p.sigma * (state.z - state.nu)
    x = apply(b_spec, rhs)
    cx = apply(spec, x)
    v, z, mu, nu = _tail(tail, prox)(x, cx, d_diag, pty, state.mu, state.nu, p)
    return DistCpadmmState(x=x, v=v, z=z, mu=mu, nu=nu)


def dist_cpadmm_step_fused(spec, b_spec, d_diag, pty, state: DistCpadmmState,
                           p: DistCpadmmParams, mesh, axis_name=MODEL_AXIS,
                           rfft: bool = False, overlap: int = 1, tail: str = "plain",
                           wire_dtype: str = "fp32", prox=None, hier: bool = False,
                           inter_wire_dtype: str = "fp32") -> DistCpadmmState:
    """Fused Alg. 3 iteration: two all-to-alls, one elementwise tail."""
    x, cx = dist_cpadmm_core(spec, b_spec, state.v + state.mu, state.z - state.nu, p, mesh,
                             axis_name, rfft, overlap, wire_dtype, hier, inter_wire_dtype)
    v, z, mu, nu = _tail(tail, prox)(x, cx, d_diag, pty, state.mu, state.nu, p)
    return DistCpadmmState(x=x, v=v, z=z, mu=mu, nu=nu)


def dist_cpadmm_core(spec, b_spec, vmu, znu, p: DistCpadmmParams, mesh,
                     axis_name=MODEL_AXIS, rfft: bool = False, overlap: int = 1,
                     wire_dtype: str = "fp32", hier: bool = False,
                     inter_wire_dtype: str = "fp32"):
    """The fused step's transform core: ``(v + mu, z - nu) -> (x, C x)``.

    One stacked forward transform, the fused local B·C^T multiply, one
    stacked inverse transform.
    """
    fwd_t, inv_t = _transforms(rfft, vmu.shape[-1], spec.dtype, mesh, axis_name, overlap,
                               wire_dtype, hier, inter_wire_dtype)
    w, zf = fwd_t(torch.stack([vmu, znu]))
    xf = b_spec * (p.rho * spec.conj() * w + p.sigma * zf)  # the spectrum of x
    x, cx = inv_t(torch.stack([xf, spec * xf]))
    return x, cx


def make_dist_spectrum(mesh, axis_name: str = MODEL_AXIS, rfft: bool = False):
    """``to_spec(col_rows)``: this rank's rows of ``layout_2d(first column)``
    -> its spectrum columns (the half layout when ``rfft``)."""

    def to_spec(col_rows: torch.Tensor) -> torch.Tensor:
        if rfft:
            return rfft2_local(col_rows, mesh, axis_name)
        dt = torch.complex128 if col_rows.dtype == torch.float64 else torch.complex64
        return fft2_local(col_rows.to(dt), mesh, axis_name)

    return to_spec



def make_dist_cpadmm(mesh, n1: int, n2: int, iters: int, fused: bool = False,
                     axis_name=MODEL_AXIS, rfft: bool = False, batch_axis=None,
                     overlap: int = 1, tail=None, wire_dtype: str = "fp32"):
    """DEPRECATED shim: ``solver(spec2d, mask2d, y2d, alpha, rho, sigma)``.

    .. deprecated:: 0.1.0
        Will be removed in repro_torch 0.2.0.  Not exported from
        ``repro_torch.dist``: reachable only by this full path until then.

    The unified path is::

        pl = repro_torch.ops.plan.plan(op, mesh, rfft=..., overlap=..., tail=...)
        z, trace = repro_torch.core.solvers.solve(problem, "cpadmm", plan=pl)

    The shim keeps the old call working: it builds a plan from this rank's
    blocks (``plan_from_parts``: ``spec2d`` its spectrum columns, ``mask2d``
    its mask rows) and runs the same ``solve`` on ``y2d``, the (..., n1, n2)
    layout of the scattered measurements ``P^T y``; it returns the recovered
    signals in that layout, whole, on every rank.  ``tail=None`` resolves
    from the blocks' device, as the plan does.
    """
    warnings.warn(
        "make_dist_cpadmm is deprecated and will be removed in repro_torch 0.2.0: build a "
        "repro_torch.ops.plan.plan and call repro_torch.core.solvers.solve(..., "
        "method='cpadmm', plan=...) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    if batch_axis is not None and batch_axis not in mesh.axis_names:
        raise ValueError(f"batch_axis {batch_axis!r} not in mesh axes {mesh.axis_names}")

    def run(spec2d, mask2d, y2d, alpha, rho, sigma):
        from ..core.solvers import RecoveryProblem, solve
        from ..ops.plan import plan_from_parts

        pl = plan_from_parts(mesh, spec2d, mask2d, n1=n1, n2=n2, rfft=rfft, overlap=overlap,
                             tail=tail, fused=fused, batch_axis=batch_axis,
                             axis_name=axis_name, wire_dtype=wire_dtype)
        prob = RecoveryProblem(op=pl.operator, y=unlayout_2d(y2d))
        z, _ = solve(prob, "cpadmm", iters=iters, record_every=iters, alpha=float(alpha),
                     rho=float(rho), sigma=float(sigma), plan=pl)
        return layout_2d(pl.gather_batch(z), n1, n2)

    return run
