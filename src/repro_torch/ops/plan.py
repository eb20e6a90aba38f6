"""Execution plans: lower a recovery operator to one device or to a mesh.

Port of ``repro/ops/plan.py``.  ``plan(op)`` is the identity lowering: the
plan's operator *is* ``op``.  ``plan(op, mesh)`` lowers a (partial)
circulant onto the four-step transforms of :mod:`repro_torch.dist.fft`:
matvecs become two transpose all-to-alls each, and the CPADMM inner
inverse stays a pointwise reciprocal on this rank's spectrum columns.
Either way the *same* drivers of :mod:`repro_torch.core.solvers` run it.

Distributed measurement convention: on a mesh the plan works in the mask
form ``M = diag(mask) C`` with measurements scattered full length
(``P^T y``): ``M^T M = A^T A`` and ``M^T P^T y = A^T y``, so the iterates
are those of the m-row operator.

Each rank holds its columns of the spectrum (``spec2d``) and its rows of
the mask (``mask2d``); every rank builds the same problem from the same
seed and keeps its blocks.  The solver state is this rank's rows; the
batch of signals stays local to the data axis (``batch_axis``), and a
stepper's ``extract`` all-gathers its signals' rows over the model axis,
so the drivers see whole signals.

Knobs (one frozen :class:`PlanConfig`):

    tail        'plain' (the reference's 'jnp') or 'kernel' (its 'pallas'):
                the hand-written kernels for the CPADMM tail (and, on one
                device, the CPISTA and spectral steps); None (the default)
                resolves when the plan is built (:func:`resolve_tail`):
                'kernel' on a CUDA device for the operators the kernel
                steps take, 'plain' elsewhere
    prox        the prior; None = the l1 soft threshold
    rfft        half-spectrum transforms (half the FFT flops and wire bytes)
    overlap=K   chunked transposes overlapped with the first FFT stage
    fused       the frequency-domain CPADMM x-update (2 all-to-alls per
                iteration instead of 6)
    batch_axis  the mesh axis a leading batch of signals is split over
    n1, n2      the four-step factorization (auto near sqrt(n))
    axis_name   the mesh axis the transforms split over
    wire_dtype  'fp32' / 'bf16' / 'fp16': the transpose payload precision,
                guarded by a one-matvec probe that falls back to 'fp32'
                past :data:`WIRE_ERROR_BOUND`
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..dist.compat import MODEL_AXIS, Mesh, gather_cat
from ..dist.fft import (
    col_block,
    gather_rows,
    layout_2d,
    matvec_local,
    rmatvec_local,
    row_block,
    unlayout_2d,
)
from ..kernels.wire_pack.ref import WIRE_DTYPES
from . import prox as prox_mod
from . import spectral

TAILS = ("plain", "kernel")
_ISTA_METHODS = ("ista", "fista", "cpista")

# wire-precision guard: a plan with wire_dtype != 'fp32' probes one matvec
# against its fp32-wire twin and falls back (RuntimeWarning) past this
# relative error; REPRO_WIRE_ERROR_BOUND overrides it, as in the reference
WIRE_ERROR_BOUND = float(os.environ.get("REPRO_WIRE_ERROR_BOUND", "1e-2"))


def _factorize(n: int, n1: Optional[int], n2: Optional[int], p: int, rfft: bool):
    """Pick or check the four-step n = n1 x n2 split for a p-rank axis: the
    rows must split evenly over the axis, and so must the spectrum columns
    unless the rfft path pads them."""
    if n1 is not None and n2 is None:
        n2 = n // n1
    if n1 is None and n2 is not None:
        n1 = n // n2
    if n1 is None:
        for cand in range(math.isqrt(n), 0, -1):
            if n % cand:
                continue
            a, b = cand, n // cand
            if a % p == 0 and (rfft or b % p == 0):
                n1, n2 = a, b
                break
        else:
            raise ValueError(
                f"no n1 x n2 = {n} factorization shards over {p} devices; "
                f"pass n1/n2 explicitly"
            )
    if n1 * n2 != n:
        raise ValueError(f"n1 * n2 = {n1}*{n2} != n = {n}")
    if n1 % p:
        raise ValueError(f"n1 = {n1} must be divisible by the mesh axis size {p}")
    if not rfft and n2 % p:
        raise ValueError(
            f"n2 = {n2} must be divisible by the mesh axis size {p} "
            f"(or use rfft=True, which pads the kept columns)"
        )
    return n1, n2


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Every knob of an execution plan, in one frozen hashable value."""

    tail: str = "plain"
    prox: Any = None  # a prox (apply(x, gamma) + tag); None = the l1 threshold
    rfft: bool = False
    overlap: int = 1
    fused: bool = True
    batch_axis: Any = None
    n1: Optional[int] = None
    n2: Optional[int] = None
    axis_name: Any = MODEL_AXIS
    wire_dtype: str = "fp32"

    def validate(self, distributed: bool = False) -> "PlanConfig":
        """THE validation site for plan knobs; returns self for chaining."""
        if self.tail not in TAILS:
            raise ValueError(f"tail must be one of {TAILS}, got {self.tail!r}")
        if self.prox is not None and not (
            hasattr(self.prox, "apply") and hasattr(self.prox, "tag")
        ):
            raise ValueError(
                f"prox must be None (the l1 soft threshold) or a prox with "
                f"apply(x, gamma) and tag; got {self.prox!r}"
            )
        if not isinstance(self.overlap, int) or self.overlap < 1:
            raise ValueError(f"overlap must be a positive int, got {self.overlap!r}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype must be one of {sorted(WIRE_DTYPES)}, got {self.wire_dtype!r}"
            )
        if not isinstance(self.axis_name, str):
            raise ValueError(
                f"axis_name must be one mesh-axis name, got {self.axis_name!r} (the "
                f"hierarchical (host, device) exchange is not ported yet: ROADMAP "
                f"Queue 1 item 9 step 7)"
            )
        if not distributed and self.wire_dtype != "fp32":
            raise ValueError(
                f"wire_dtype={self.wire_dtype!r} compresses the transpose "
                f"all-to-all payload of the *distributed* four-step "
                f"transforms — a local (mesh=None) plan has no wire to "
                f"compress and would silently ignore it; pass a mesh or "
                f"leave wire_dtype='fp32' (valid values: "
                f"{sorted(WIRE_DTYPES)})"
            )
        if not distributed and (self.rfft or self.overlap != 1 or self.batch_axis is not None):
            raise ValueError(
                "rfft/overlap are distributed-backend knobs (the sharded "
                "four-step transforms), and batch_axis names a mesh axis; "
                "pass a mesh to use them — a local plan would silently "
                "ignore them"
            )
        if (self.n1 is not None and self.n1 < 1) or (self.n2 is not None and self.n2 < 1):
            raise ValueError(f"n1/n2 must be positive, got {self.n1}/{self.n2}")
        return self

    def to_dict(self) -> dict:
        """A JSON-safe dict of every knob (the prox by its ``to_dict``)."""
        d = dataclasses.asdict(self)
        for key in ("batch_axis", "axis_name"):
            if isinstance(d[key], tuple):
                d[key] = list(d[key])
        d["prox"] = prox_mod.prox_to_dict(self.prox)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PlanConfig":
        """Inverse of :meth:`to_dict`.  The reference's two hierarchical
        knobs are accepted at their defaults (``hier_axes=None``,
        ``inter_wire_dtype='fp32'``): the port has no such exchange yet."""
        d = dict(d)
        hier = (d.pop("hier_axes", None), d.pop("inter_wire_dtype", "fp32"))
        if hier != (None, "fp32"):
            raise ValueError(
                f"hier_axes={hier[0]!r} / inter_wire_dtype={hier[1]!r} select the "
                f"hierarchical (host, device) exchange, which is not ported yet: ROADMAP "
                f"Queue 1 item 9 step 7"
            )
        for key in ("batch_axis", "axis_name"):
            if isinstance(d.get(key), list):
                d[key] = tuple(d[key])
        if d.get("prox") is not None:
            d["prox"] = prox_mod.prox_from_dict(d["prox"])
        return cls(**d)

    def describe(self) -> str:
        """Compact human-readable tag: every knob that changes the step
        shows (the reference's tag, with the port's tail names)."""
        parts = [
            f"n1xn2={self.n1}x{self.n2}" if self.n1 else "n1xn2=auto",
            f"rfft={'on' if self.rfft else 'off'}",
            f"overlap={self.overlap}",
            f"tail={self.tail}",
        ]
        if not self.fused:
            parts.append("unfused")
        if self.batch_axis is not None:
            parts.append(f"batch_axis={self.batch_axis}")
        if self.wire_dtype != "fp32":
            parts.append(f"wire={self.wire_dtype}")
        if self.prox is not None:
            # the prior changes the z-update: every non-default prox shows
            parts.append(f"prox={self.prox.tag}")
        return " ".join(parts)


class PlannedOperator:
    """Mask form ``diag(mask) C`` on the plan's mesh, acting on flat signals.

    ``matvec`` / ``rmatvec`` take whole flat (..., n) signals (the local
    batch), run the four-step transforms on this rank's rows and gather the
    result's rows, so the drivers' objective and metric code work
    unchanged.  Measurements are scattered full length (``project_back``
    is the identity).
    """

    def __init__(self, plan: "ExecutionPlan"):
        self._plan = plan

    @property
    def n(self) -> int:
        return self._plan.n1 * self._plan.n2

    @property
    def m(self) -> int:
        return self.n  # mask form: measurements live scattered, length n

    def _flat(self, x: torch.Tensor, transpose: bool) -> torch.Tensor:
        pl = self._plan
        rows = row_block(layout_2d(x, pl.n1, pl.n2), pl.mesh, pl.axis_name)
        on_rows = _RowsOperator(pl)
        out = on_rows.rmatvec(rows) if transpose else on_rows.matvec(rows)
        return unlayout_2d(gather_rows(out, pl.mesh, pl.axis_name))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._flat(x, transpose=False)

    def rmatvec(self, r: torch.Tensor) -> torch.Tensor:
        return self._flat(r, transpose=True)

    def operator_norm_bound(self) -> torch.Tensor:
        return self._plan.norm_bound

    def project_back(self, y: torch.Tensor) -> torch.Tensor:
        return y  # already scattered full length


class _RowsOperator:
    """The plan's operator on this rank's rows of the (n1, n2) layout: what
    the ISTA/FISTA step math consumes, so iterates stay in the layout."""

    def __init__(self, plan: "ExecutionPlan"):
        self._plan = plan

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._plan.mask2d * self._plan._apply(x, transpose=False)

    def rmatvec(self, r: torch.Tensor) -> torch.Tensor:
        # the adjoint of diag(mask) C is C^T diag(mask)
        return self._plan._apply(self._plan.mask2d * r, transpose=True)

    def operator_norm_bound(self) -> torch.Tensor:
        return self._plan.norm_bound


def _map_state(fn, state):
    return type(state)(*(fn(leaf) for leaf in state))


@dataclasses.dataclass(frozen=True, eq=False)
class ExecutionPlan:
    """An operator lowered to a backend.  A local plan carries the operator
    and its knobs; a distributed one also this rank's spectrum columns
    ``spec2d`` and its mask rows ``mask2d``, and its config the
    factorization n1 x n2."""

    op: Any = None
    config: PlanConfig = PlanConfig()
    mesh: Any = None
    spec2d: Any = None
    mask2d: Any = None
    norm_bound: Any = None

    @property
    def is_distributed(self) -> bool:
        return self.mesh is not None

    @property
    def operator(self):
        """The original operator on one device, the mask-form planned
        operator on a mesh."""
        return PlannedOperator(self) if self.is_distributed else self.op

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.operator.matvec(x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        return self.operator.rmatvec(y)

    # -- blocks and batches -------------------------------------------------
    def _apply(self, rows: torch.Tensor, transpose: bool) -> torch.Tensor:
        """One circulant application on this rank's rows (two transposes)."""
        local = rmatvec_local if self.rfft else matvec_local
        return local(self.spec2d, rows, self.mesh, self.axis_name, transpose, self.overlap,
                     self.wire_dtype)

    def local_batch(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's signals of a flat (B, n) array: a slice over the data
        axis when the plan has a ``batch_axis``; one signal (n,) is whole."""
        return t if t.ndim < 2 else self._batch_slice(t)

    def _batch_slice(self, t: torch.Tensor) -> torch.Tensor:
        if self.batch_axis is None:
            return t
        d, idx = self.mesh.size(self.batch_axis), self.mesh.index(self.batch_axis)
        if t.shape[0] % d:
            raise ValueError(f"a batch of {t.shape[0]} signals does not split over the "
                             f"{d}-way {self.batch_axis!r} axis")
        b = t.shape[0] // d
        return t[idx * b:(idx + 1) * b]

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """All ranks' signals of this rank's batched (B/d, ...) array, on
        every rank (the array itself without a ``batch_axis``)."""
        if self.batch_axis is None:
            return t
        return gather_cat(t, self.mesh.group(self.batch_axis), dim=0)

    def _scattered_measurements(self, problem) -> torch.Tensor:
        """problem.y -> this rank's signals of the full-length P^T y."""
        y, n = problem.y, self.n1 * self.n2
        if y.shape[-1] != n:
            if not hasattr(problem.op, "project_back"):
                raise ValueError(
                    f"distributed plans need measurements of length n={n} (scattered "
                    f"P^T y) or an operator with project_back; got length {y.shape[-1]}"
                )
            y = problem.op.project_back(y)
        if y.ndim > 2:
            raise ValueError("distributed plans support one leading batch axis")
        return self.local_batch(y)

    # State leaves are this rank's rows (..., n1/p, n2) — batched when 3-D —
    # or a per-signal scalar (FISTA's t_mom, batched when 1-D).
    def global_state(self, state):
        """Gather a state to its global (B, n1, n2) arrays on every rank (the
        checkpoint's layout, the reference's global arrays)."""

        def gather(t):
            if t.ndim >= 2:
                t = gather_rows(t, self.mesh, self.axis_name)
            return self.gather_batch(t) if t.ndim in (1, 3) else t

        return _map_state(gather, state)

    def local_state(self, state):
        """This rank's blocks of a global state (:meth:`global_state`'s inverse)."""

        def keep(t):
            if t.ndim >= 2:
                t = row_block(t, self.mesh, self.axis_name)
            return self._batch_slice(t).contiguous() if t.ndim in (1, 3) else t

        return _map_state(keep, state)

    def _flat_extract(self, field: str):
        """``extract``: this rank's signals whole, their rows all-gathered
        over the model axis."""

        def extract(state):
            return unlayout_2d(gather_rows(getattr(state, field), self.mesh, self.axis_name))

        return extract

    # -- steppers (consumed by repro_torch.core.solvers) -------------------
    def build_stepper(self, problem, method: str, alpha=1e-4, rho=0.1, sigma=0.1, tau=None,
                      prox=None):
        """Lower (problem, method) to a ``Stepper`` on this backend.

        On a mesh an elementwise prior (l1, non-negative l1) acts on this
        rank's rows as they are; TV and wavelet act on whole signals, so
        the step hands them this rank's signals gathered (:class:`_LayoutProx`).
        """
        prox = prox if prox is not None else self.prox
        if not self.is_distributed:
            from ..core.solvers import make_stepper

            return make_stepper(problem, method, alpha=alpha, rho=rho, sigma=sigma, tau=tau,
                                plan=self, prox=prox)
        if method in _ISTA_METHODS:
            return self._ista_stepper(problem, method, alpha, tau, prox)
        if method == "cpadmm":
            return self._cpadmm_stepper(problem, alpha, rho, sigma, tau, prox)
        raise ValueError(
            f"method {method!r} has no distributed lowering; valid "
            f"distributed methods: ista, fista, cpista, cpadmm"
        )

    def _ista_stepper(self, problem, method: str, alpha, tau, prox=None):
        """Distributed CPISTA/FISTA: the core step math verbatim, with the
        matvecs on this rank's rows."""
        from ..core import ista as ista_mod
        from ..core.solvers import Stepper

        y_full = self._scattered_measurements(problem)
        y_rows = row_block(layout_2d(y_full, self.n1, self.n2), self.mesh, self.axis_name)
        op_rows = _RowsOperator(self)
        tau_v = tau if tau is not None else ista_mod.default_tau(op_rows)
        p = ista_mod.IstaParams(alpha=float(alpha), tau=tau_v)
        step_fn = ista_mod.fista_step if method == "fista" else ista_mod.ista_step
        prox = prox if prox_mod.is_elementwise(prox) else _LayoutProx(prox, self)
        zeros = torch.zeros_like(y_rows)
        # per-signal momentum, as ista_init: a frozen slot keeps a solo run's schedule
        return Stepper(
            init=lambda: ista_mod.IstaState(
                x=zeros, x_prev=zeros, t_mom=y_full.new_ones(y_full.shape[:-1])
            ),
            step=lambda s: step_fn(op_rows, y_rows, s, p, prox=prox),
            extract=self._flat_extract("x"),
        )

    def _cpadmm_stepper(self, problem, alpha, rho, sigma, tau, prox=None):
        """Distributed CPADMM: the step functions of
        :mod:`repro_torch.dist.recovery` on this rank's blocks.

        A non-elementwise prior takes the reference's hybrid step: the
        fused transform core (``dist_cpadmm_core``), then the plain tail
        with the prior on the gathered signals, whatever ``fused`` says."""
        from ..core.solvers import Stepper
        from ..dist.recovery import (
            DistCpadmmParams,
            DistCpadmmState,
            dist_cpadmm_step,
            dist_cpadmm_step_fused,
        )

        y_full = self._scattered_measurements(problem)
        pty = row_block(layout_2d(y_full, self.n1, self.n2), self.mesh, self.axis_name)
        t = 1.0 if tau is None else float(tau)
        p = DistCpadmmParams(alpha=float(alpha), rho=float(rho), sigma=float(sigma),
                             tau1=t, tau2=t)
        # Alg. 3 line 2 on this rank's blocks: both inner inverses are pointwise
        b_spec = spectral.gram_inverse_spectrum(self.spec2d, p.rho, p.sigma)
        d_diag = torch.where(self.mask2d > 0, 1.0 / (1.0 + p.rho), 1.0 / p.rho).to(pty.dtype)
        step_fn = dist_cpadmm_step_fused if self.fused else dist_cpadmm_step
        if not prox_mod.is_elementwise(prox):
            step_fn, prox = dist_cpadmm_step_fused, _LayoutProx(prox, self)
        zeros = torch.zeros_like(pty)
        return Stepper(
            init=lambda: DistCpadmmState(zeros, zeros, zeros, zeros, zeros),
            step=lambda s: step_fn(self.spec2d, b_spec, d_diag, pty, s, p, self.mesh,
                                   self.axis_name, self.rfft, self.overlap, self.tail,
                                   self.wire_dtype, prox=prox),
            extract=self._flat_extract("z"),
        )


class _LayoutProx:
    """A whole-signal prox (TV, wavelet) on this rank's rows of the four-step
    layout: all-gather the rows over the model axis, ``unlayout_2d`` to the
    flat signals, apply, ``layout_2d`` back and keep this rank's rows.

    ``layout_2d`` is strided (``A[j1, j2] = x[j1 + n1*j2]``), so a plain
    reshape would scramble the signal without an error.  Every rank of the
    model axis repeats the prox on the whole signal (the reference's GSPMD
    partitions it instead); the batch stays split over the data axis.
    """

    def __init__(self, prox, plan: "ExecutionPlan"):
        self._prox, self._plan = prox, plan

    def apply(self, rows: torch.Tensor, gamma) -> torch.Tensor:
        pl = self._plan
        flat = unlayout_2d(gather_rows(rows, pl.mesh, pl.axis_name))
        out = self._prox.apply(flat, gamma)
        return row_block(layout_2d(out, pl.n1, pl.n2), pl.mesh, pl.axis_name)


# the knobs read as plan attributes, as the reference's plan fields do
for _knob in ("tail", "prox", "rfft", "overlap", "fused", "batch_axis", "n1", "n2",
              "axis_name", "wire_dtype"):
    setattr(ExecutionPlan, _knob, property(lambda self, k=_knob: getattr(self.config, k)))


def _wire_guard(wire_plan: ExecutionPlan) -> ExecutionPlan:
    """Error-controlled wire precision: probe one matvec of the demoted-wire
    plan against its fp32-wire twin on a seeded unit-norm signal, and fall
    back to fp32 (``RuntimeWarning``) when the relative error exceeds
    :data:`WIRE_ERROR_BOUND` or is not finite (fp16 overflow).  Every rank
    takes the same decision."""
    if wire_plan.wire_dtype == "fp32":
        return wire_plan
    ref_plan = dataclasses.replace(
        wire_plan, config=dataclasses.replace(wire_plan.config, wire_dtype="fp32")
    )
    n = wire_plan.n1 * wire_plan.n2
    x = torch.randn(n, generator=torch.Generator().manual_seed(0))
    x = (x / x.norm()).to(wire_plan.mask2d.device)
    got, ref = wire_plan.matvec(x), ref_plan.matvec(x)
    denom = ref.norm()
    err = float((got - ref).norm() / torch.where(denom > 0, denom, torch.ones_like(denom)))
    bound = WIRE_ERROR_BOUND
    ok = torch.tensor([1.0 if err <= bound else 0.0], device=wire_plan.mesh.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if ok.item() < 1.0:
        warnings.warn(
            f"wire_dtype={wire_plan.wire_dtype!r} failed the precision guard: relative "
            f"matvec error {err:.3e} exceeds the bound {bound:.1e} "
            f"(REPRO_WIRE_ERROR_BOUND) on some rank — falling back to fp32 wires",
            RuntimeWarning,
            stacklevel=3,
        )
        return ref_plan
    return wire_plan


def resolve_tail(tail: Optional[str], op=None, device=None) -> str:
    """The step a plan runs when it is built: ``tail`` itself when one is
    given; else 'kernel' where the operands lie on a CUDA device and the
    kernel steps take the operator, 'plain' elsewhere.

    On one device the kernel steps take a ``PartialCirculant`` (the deblur
    problem's joint operator is one), and ``device`` defaults to its
    tensors' device; every other operator (a ``Circulant``, a
    ``DenseOperator``) resolves to 'plain', whose steps serve it.  On a mesh
    (``op=None``) the fused tail runs on any operator's blocks, and
    ``device`` is the one the rank's blocks live on.  The reference's plan
    defaults to its plain tail and leaves the choice to its tuner; the port
    chooses from the device, so the CLI runs the kernels on the card.
    """
    if tail is not None:
        return tail
    if op is not None:
        from ..core.circulant import PartialCirculant  # here: core's drivers import ops

        if not isinstance(op, PartialCirculant):
            return "plain"
        device = op.circ.col.device if device is None else device
    return "kernel" if device is not None and torch.device(device).type == "cuda" else "plain"


def _check_mesh(mesh, cfg: PlanConfig) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a repro_torch.dist.compat.Mesh (make_mesh), got {type(mesh).__name__}"
        )
    for name in (cfg.axis_name, cfg.batch_axis):
        if name is not None and name not in mesh.axis_names:
            raise ValueError(f"axis {name!r} not in mesh axes {mesh.axis_names}")


def plan(op, mesh=None, *, n1=None, n2=None, rfft=False, overlap=1, tail=None,
         fused=True, batch_axis=None, axis_name=MODEL_AXIS, wire_dtype="fp32",
         prox=None) -> ExecutionPlan:
    """Lower ``op`` to an execution plan (see module docstring).

    With ``mesh=None`` the identity lowering; with a :class:`Mesh`, ``op``
    must be a (partial) circulant, whose stored half spectrum is laid out
    into this rank's four-step spectrum columns.  ``tail=None`` resolves
    from the operands' device (:func:`resolve_tail`).
    """
    tail = resolve_tail(tail, op) if mesh is None else resolve_tail(
        tail, device=getattr(mesh, "device", None))
    cfg = PlanConfig(n1=n1, n2=n2, rfft=rfft, overlap=overlap, tail=tail, fused=fused,
                     batch_axis=batch_axis, axis_name=axis_name, wire_dtype=wire_dtype,
                     prox=prox).validate(distributed=mesh is not None)
    if mesh is None:
        return ExecutionPlan(op=op, config=cfg)
    _check_mesh(mesh, cfg)
    if hasattr(op, "circ"):  # PartialCirculant: mask = indicator of omega
        circ, omega = op.circ, op.omega
    elif hasattr(op, "spec") and hasattr(op, "col"):  # full Circulant
        circ, omega = op, None
    else:
        raise TypeError(
            f"distributed plans need a (partial) circulant operator, got {type(op).__name__}"
        )
    if circ.spec.device != mesh.device:
        raise ValueError(f"the operator lies on {circ.spec.device}, this rank's mesh on "
                         f"{mesh.device}")
    n, p = circ.n, mesh.size(cfg.axis_name)
    n1, n2 = _factorize(n, cfg.n1, cfg.n2, p, cfg.rfft)
    mask = torch.ones((n,), dtype=circ.col.dtype, device=mesh.device)
    if omega is not None:
        mask = torch.zeros_like(mask).index_fill_(0, omega, 1.0)
    # the operator's stored half spectrum, re-laid out: no transform runs, so
    # a composed spectrum (deblur's spec(C)·spec(B)) never visits the time domain
    spec2d = spectral.spectrum_layout_2d(circ.spec, n1, n2, rfft=cfg.rfft, p=p)
    built = ExecutionPlan(
        op=op, config=dataclasses.replace(cfg, n1=n1, n2=n2), mesh=mesh,
        spec2d=col_block(spec2d, mesh, cfg.axis_name),
        mask2d=row_block(layout_2d(mask, n1, n2), mesh, cfg.axis_name),
        norm_bound=op.operator_norm_bound(),
    )
    return _wire_guard(built)


def plan_from_parts(mesh, spec2d, mask2d, *, n1=None, n2=None, rfft=False, overlap=1,
                    tail=None, fused=True, batch_axis=None, axis_name=MODEL_AXIS,
                    wire_dtype="fp32", prox=None) -> ExecutionPlan:
    """A distributed plan from this rank's blocks instead of an operator:
    ``spec2d`` its spectrum columns (in the ``rfft`` layout), ``mask2d`` its
    rows of the 0/1 measurement mask (``repro_torch.interop.
    plan_parts_from_numpy`` cuts them from global arrays).  With no operator
    to read ``n`` from, ``n1 x n2`` must be given.  No precision guard:
    :func:`plan` is the guarded route.  ``tail=None`` resolves from the
    blocks' device (:func:`resolve_tail`).
    """
    tail = resolve_tail(tail, device=spec2d.device)
    cfg = PlanConfig(n1=n1, n2=n2, rfft=rfft, overlap=overlap, tail=tail, fused=fused,
                     batch_axis=batch_axis, axis_name=axis_name, wire_dtype=wire_dtype,
                     prox=prox).validate(distributed=True)
    if cfg.n1 is None or cfg.n2 is None:
        raise ValueError(
            "plan_from_parts has no operator to infer n from: pass a "
            "concrete n1 x n2 factorization"
        )
    _check_mesh(mesh, cfg)
    norm = spec2d.abs().max().reshape(1)
    dist.all_reduce(norm, op=dist.ReduceOp.MAX, group=mesh.group(cfg.axis_name))
    return ExecutionPlan(config=cfg, mesh=mesh, spec2d=spec2d, mask2d=mask2d,
                         norm_bound=norm[0])
