"""The system under test: the PyTorch and CUDA port, ``repro_torch``.

The only harness module besides the entries that imports the program.  It
builds the program's objects from the benchmark's raw inputs the way a user
of the port would: the operator from its first column and row set, the
prior by name, the execution plan by the deployment's own entry.
"""

from __future__ import annotations

import torch


def operator(col: torch.Tensor, omega: torch.Tensor):
    """The partial circulant A = P C from C's first column and the row set."""
    from repro_torch.core.circulant import Circulant, PartialCirculant

    return PartialCirculant(Circulant.from_first_col(col), omega)


def prox(prior: str):
    """The prior by name; the paper's l1 is the default (None), which keeps
    the fused kernel steps eligible."""
    if prior == "l1":
        return None
    from repro_torch.ops.prox import prox_from_dict

    return prox_from_dict({"kind": prior})


def plan(cfg: dict, op, prox_obj):
    """The plan a user builds for this deployment: ``build_deblur_plan`` for
    the Sec. 7 frames (its ``image`` read for shape alone), ``plan(op)``
    for Sec. 6 signals."""
    if cfg["problem"] == "deblur":
        from repro_torch.core.deblur import DeblurProblem, build_deblur_plan

        shape = (cfg["height"], cfg["width"])
        problem = DeblurProblem(op=op, blur=None, y=None,
                                image=torch.empty((1,) + shape, device="meta"))
        return build_deblur_plan(problem, prox=prox_obj)
    from repro_torch.ops.plan import plan as make_plan

    return make_plan(op, prox=prox_obj)


def solver_kw(cfg: dict) -> dict:
    return dict(alpha=cfg["alpha"], rho=cfg["rho"], sigma=cfg["sigma"])
