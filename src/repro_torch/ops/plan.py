"""Execution plans, local subset: the identity lowering and its knobs.

Port of the single-device half of ``repro/ops/plan.py``.  ``plan(op)``
returns an :class:`ExecutionPlan` whose operator *is* ``op``; the drivers
of :mod:`repro_torch.core.solvers` read two knobs from it:

    tail   'plain' (default; the reference's 'jnp') or 'kernel' (the
           reference's 'pallas'): the CPADMM and ISTA/CPISTA steps on the
           hand-written kernels of :mod:`repro_torch.core.kernel_backend`
    prox   the prior (:mod:`repro_torch.ops.prox`); None = l1 threshold

Distributed lowering (``mesh=``) is ROADMAP Queue 1 item 9 and raises here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

TAILS = ("plain", "kernel")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Every knob of a local execution plan, in one frozen hashable value."""

    tail: str = "plain"
    prox: Any = None  # a Prox (apply(x, gamma) + tag); None = the l1 threshold

    def validate(self) -> "PlanConfig":
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
        return self


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """An operator lowered to one device: the operator and its knobs."""

    op: Any
    config: PlanConfig = PlanConfig()

    @property
    def tail(self) -> str:
        return self.config.tail

    @property
    def prox(self):
        return self.config.prox

    @property
    def is_distributed(self) -> bool:
        return False

    @property
    def operator(self):
        """The RecoveryOperator view of this plan: ``op`` itself."""
        return self.op


def plan(op, mesh=None, *, tail: str = "plain", prox: Any = None) -> ExecutionPlan:
    """Lower ``op`` to a local execution plan (the identity lowering)."""
    if mesh is not None:
        raise NotImplementedError(
            "distributed plans (mesh=) are not ported yet: ROADMAP Queue 1 "
            "item 9 (distributed transforms and recovery)"
        )
    return ExecutionPlan(op=op, config=PlanConfig(tail=tail, prox=prox).validate())
