"""AdamW + global-norm clipping + warmup-cosine schedule.

Port of ``repro/optim/adamw.py``: the same configuration fields and
defaults, the same arithmetic in float32 (``moment_dtype`` sets the dtype
the moments are stored in).  Weight decay applies to every leaf, norms and
``router_bias`` included.  The state is a NamedTuple ``(mu, nu, count)``
of trees shaped like the parameters.

Two differences from the reference, both deliberate:

* :func:`update` writes the new parameters and moments into the given
  tensors in place (``copy_`` under ``torch.no_grad()``; never through
  ``.data``, which would hide the write from ``_version``, the counter the
  step functions' cast cache reads) and returns them, where the reference
  returns new arrays: the state is 16 bytes a parameter, and a second copy
  would not fit the card at full width;
* a ``None`` gradient counts as zeros, in :func:`global_norm` and in
  :func:`update`: autograd gives no gradient to a leaf the loss does not
  reach (``router_bias``, used only through ``topk``'s indices), where the
  reference's ``jax.grad`` gives zeros, and its weight decay still moves it.

``torch.optim.AdamW`` is not used: its schedule, clipping and
``moment_dtype`` are not the reference's.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor  # int32 scalar


class AdamWConfig(NamedTuple):
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def _leaves(tree) -> list:
    """The leaves of nested dicts and lists, dicts in sorted key order (the
    reference's flattening order, which fixes the order of sums)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine to ``lr_min_ratio *
    lr_peak`` at ``total_steps``; float32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr_peak * step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def init(params: dict, cfg: AdamWConfig) -> AdamWState:
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    device = _leaves(params)[0].device
    return AdamWState(mu=_map(zeros, params), nu=_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32; ``None`` leaves
    count as zeros."""
    leaves = [leaf for leaf in _leaves(tree) if leaf is not None]
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


def update(params: dict, grads, state: AdamWState,
           cfg: AdamWConfig) -> Tuple[dict, AdamWState, dict]:
    """-> (params, new_state, metrics): one clipped AdamW step.  ``params``
    and the moments of ``state`` are updated in place and returned; the new
    state's ``count`` is a new tensor.  ``grads`` is shaped like ``params``
    and may hold ``None`` leaves (zeros)."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        count = state.count + 1
        lr = schedule(cfg, count)
        c1 = 1.0 - cfg.b1 ** count.float()
        c2 = 1.0 - cfg.b2 ** count.float()
        flat_g: List[Optional[torch.Tensor]] = _leaves(grads)
        for p, g, m, v in zip(_leaves(params), flat_g, _leaves(state.mu), _leaves(state.nu)):
            g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float() * scale
            m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
            v32 = v.float() * cfg.b2 + g * g * (1 - cfg.b2)
            del g
            step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
            step = step + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            m.copy_(m32)
            v.copy_(v32)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(mu=state.mu, nu=state.nu, count=count), metrics
