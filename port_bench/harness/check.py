"""The comparison that decides ``correct``: the program's answers against
the plain reference, run after the window in blocks.

Numbers compared (each against its limit in ``limits/<workload>.json``):

  missing    answers due in the window that never came (limit 0)
  x_rel_err  the largest ||x - x_ref|| / ||x_ref|| over the answers' signals,
             x_ref the float64 reference after the same number of steps
             (the fixed count, or the count the program reported)
  stop_gap   tolerance-driven answers only: how far the reference's own
             relative changes disagree with the count the program reported.
             A signal stopped below ``max_iters`` needs the reference's last
             change at or under tol: its excess is last / tol - 1.  A signal
             kept going past ``min_iters`` needs every earlier change above
             tol: its shortfall is 1 - least / tol.  The largest of the two,
             over every signal, 0 when the count is the reference's.

A non-finite answer reads inf.  The control (``control``) puts the
reference, computed with its arrays in bfloat16, in the program's place.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference.cpadmm import Cpadmm

from .record import Answers

ELEMENTS_PER_BLOCK = 1 << 22  # rows x n of one reference block: 32 MiB an array in float64


def _rows(n: int) -> int:
    return max(1, ELEMENTS_PER_BLOCK // n)


def _solver(ans: Answers, y: torch.Tensor, precision: str) -> Cpadmm:
    return Cpadmm(ans.col, ans.omega, y, prior=ans.prior, precision=precision, **ans.params)


def _rel_err(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    err = torch.linalg.vector_norm(x.double() - ref.double(), dim=-1)
    err = err / torch.linalg.vector_norm(ref.double(), dim=-1).clamp_min(1e-30)
    return torch.where(torch.isfinite(err), err, torch.full_like(err, math.inf))


def compare(ans: Answers) -> Dict[str, float]:
    """-> {name: number} for the answers (see the module docstring)."""
    # nothing to judge is an answer that never came
    out = {"missing": float(ans.missing if ans.blocks else max(ans.missing, 1)), "x_rel_err": 0.0}
    if ans.kind == "until":
        out["stop_gap"] = 0.0
    rows = _rows(ans.col.shape[-1])
    for blk in ans.blocks:
        for a in range(0, blk["y"].shape[0], rows):
            part = {k: v[a:a + rows] for k, v in blk.items()}
            ref = _solver(ans, part["y"], "float64")
            if ans.kind == "fixed":
                z = ref.run_fixed(ans.iters)
            else:
                z, last, least = ref.run_to_counts(part["count"], part["min"])
                tol = part["tol"].double()
                early = torch.where(part["count"] < part["max"], last / tol - 1.0,
                                    torch.zeros_like(last))
                late = 1.0 - least / tol
                gap = torch.clamp(torch.maximum(early, late), min=0.0)
                out["stop_gap"] = max(out["stop_gap"], float(gap.max()))
            out["x_rel_err"] = max(out["x_rel_err"], float(_rel_err(part["x"], z).max()))
            del ref, z
    return out


def control(ans: Answers) -> Answers:
    """The answers the bfloat16 reference gives in the program's place, on
    the same inputs and contracts."""
    blocks = []
    rows = _rows(ans.col.shape[-1])
    for blk in ans.blocks:
        xs, counts = [], []
        for a in range(0, blk["y"].shape[0], rows):
            part = {k: v[a:a + rows] for k, v in blk.items()}
            ctl = _solver(ans, part["y"], "bfloat16")
            if ans.kind == "fixed":
                xs.append(ctl.run_fixed(ans.iters).float())
            else:
                x, c = ctl.run_until(part["tol"], part["min"], part["max"])
                xs.append(x.float())
                counts.append(c)
        new = dict(blk, x=torch.cat(xs))
        if counts:
            new["count"] = torch.cat(counts)
        blocks.append(new)
    return Answers(kind=ans.kind, col=ans.col, omega=ans.omega, prior=ans.prior,
                   params=ans.params, blocks=blocks, iters=ans.iters, missing=ans.missing)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit; a number without a limit fails."""
    return all(name in limits and numbers[name] <= limits[name] for name in numbers)
