"""AdamW + global-norm clipping + warmup-cosine schedule.

Port of ``repro/optim/adamw.py``: the same configuration fields and
defaults, the same arithmetic in float32 (``moment_dtype`` sets the dtype
the moments are stored in).  Weight decay applies to every leaf, norms and
``router_bias`` included.  The state is a NamedTuple ``(mu, nu, count)``
of trees shaped like the parameters.

Two differences from the reference, both deliberate:

* :func:`update` writes the new parameters and moments into the given
  tensors in place (in-place operations under ``torch.no_grad()``, a leaf
  CHUNK elements at a time, so that its float32 temporaries stay small;
  never through ``.data``, which would hide the write from ``_version``,
  the counter the step functions' cast cache reads) and returns them,
  where the reference returns new arrays: the state is 16 bytes a
  parameter, and a second copy would not fit the card at full width;
* a ``None`` gradient counts as zeros, in :func:`global_norm` and in
  :func:`update`: autograd gives no gradient to a leaf the loss does not
  reach (``router_bias``, used only through ``topk``'s indices), where the
  reference's ``jax.grad`` gives zeros, and its weight decay still moves it.

``torch.optim.AdamW`` is not used: its schedule, clipping and
``moment_dtype`` are not the reference's.

On a mesh (``specs``, the parameters' partition specs, and ``mesh``:
:mod:`repro_torch.dist.blocks`) every rank holds its blocks of the
parameters, moments and gradients; the update is elementwise, so it runs on
the blocks, and the clip reads the exact global norm: each leaf's sum of
squares summed over the mesh axes it is split on, a replicated leaf
counted once.
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


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32; ``None`` leaves
    count as zeros.  With ``specs`` (the partition spec of every leaf of
    ``tree`` in its insertion order: :func:`repro_torch.dist.blocks.leaf_specs`)
    and ``mesh``, the leaves are this rank's blocks: each block's sum of
    squares is summed over the axes its leaf is split on (one small
    all-reduce an axis), so every rank gets the global tree's norm."""
    leaves = _leaves(tree)
    if specs is None or mesh is None:
        axes = [frozenset()] * len(leaves)
    else:
        from ..dist.blocks import spec_axes

        it = iter(specs)  # in the tree's order; _leaves takes sorted keys
        axes = _leaves(_map(lambda _: frozenset(spec_axes(next(it))), tree))
    sums: dict = {}  # split axes -> the sum of squares of those leaves' blocks
    for leaf, split in zip(leaves, axes):
        if leaf is not None:
            sq = torch.sum(torch.square(leaf.float()))
            sums[split] = sq if split not in sums else sums[split] + sq
    if not any(sums):
        return torch.sqrt(sum(sums.values()))
    import torch.distributed as dist

    keys = sorted(sums, key=sorted)
    vec = torch.stack([sums[k] for k in keys])
    for axis in sorted(set().union(*keys)):
        mask = torch.tensor([axis in k for k in keys], device=vec.device)
        part = torch.where(mask, vec, 0.0)
        dist.all_reduce(part, group=mesh.group(axis))
        vec = torch.where(mask, part, vec)
    return torch.sqrt(vec.sum())


CHUNK = 1 << 24  # elements of a leaf updated together (64 MB of each float32 temporary)


def _chunks(p, g, m, v):
    """(p, g, m, v) in pieces of at most CHUNK elements, views of the
    state's tensors (so the update stays in place), or whole when one of
    them is not contiguous; ``g`` may be ``None``."""
    n = p.numel()
    if n <= CHUNK or not all(t.is_contiguous() for t in (p, m, v)):
        return [(p, g, m, v)]
    pieces = [t.view(-1).split(CHUNK) for t in (p, m, v)]
    gs = [None] * len(pieces[0]) if g is None else g.reshape(-1).split(CHUNK)
    return list(zip(pieces[0], gs, pieces[1], pieces[2]))


def _update_chunk(p, g, m, v, scale, lr, c1, c2, cfg: AdamWConfig) -> None:
    """One clipped AdamW update of a piece of a leaf, in place, in the
    reference's float32 operations and order; float32 moments and
    parameters are written through, others through a float32 copy."""
    g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float() * scale
    m32, v32, p32 = m.float(), v.float(), p.float()  # themselves when float32
    m32.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    t = g * g
    del g
    v32.mul_(cfg.b2).add_(t.mul_(1 - cfg.b2))
    torch.div(v32, c2, out=t)
    step = (m32 / c1).div_(t.sqrt_().add_(cfg.eps))
    torch.mul(p32, cfg.weight_decay, out=t)
    step.add_(t)
    del t
    p32.sub_(step.mul_(lr))
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:
            dst.copy_(src)


def update(params: dict, grads, state: AdamWState, cfg: AdamWConfig, specs=None,
           mesh=None) -> Tuple[dict, AdamWState, dict]:
    """-> (params, new_state, metrics): one clipped AdamW step.  ``params``
    and the moments of ``state`` are updated in place and returned; the new
    state's ``count`` is a new tensor.  ``grads`` is shaped like ``params``
    and may hold ``None`` leaves (zeros).  ``specs`` (the partition spec of
    every leaf in the tree's order) and ``mesh``: the leaves are this rank's
    blocks (:func:`global_norm`)."""
    with torch.no_grad():
        gnorm = global_norm(grads, specs, mesh)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        count = state.count + 1
        lr = schedule(cfg, count)
        c1 = 1.0 - cfg.b1 ** count.float()
        c2 = 1.0 - cfg.b2 ** count.float()
        flat_g: List[Optional[torch.Tensor]] = _leaves(grads)
        for p, g, m, v in zip(_leaves(params), flat_g, _leaves(state.mu), _leaves(state.nu)):
            for chunk in _chunks(p, g, m, v):
                _update_chunk(*chunk, scale, lr, c1, c2, cfg)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(mu=state.mu, nu=state.nu, count=count), metrics
