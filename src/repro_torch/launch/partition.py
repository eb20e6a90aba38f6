"""Parameter / state / batch / cache partition specs, and each rank's shards.

Port of ``repro/launch/partition.py``.  Name-based rules over the
parameter-tree paths give every leaf a spec derived from what the tensor
*is* (attention projection, expert weight, vocab table, ...), resolved
against the active per-arch sharding rules
(:func:`repro_torch.dist.sharding.rules_for_arch` handles non-divisible
fallbacks).  A spec is a tuple with one entry a leading dimension: the
physical mesh axis (or tuple of axes) the dimension is split over, or
``None``; dimensions past its end are replicated, and ``()`` is a leaf
replicated whole — the reference's ``PartitionSpec`` as a plain tuple.

Conventions (leading ``L`` is the stacked-layer axis of a segment):
    embed/table        (V, D)              vocab-sharded rows
    attn wq/wk/wv      (L, D, H*hd)        TP on the head-flat output dim
    attn wo            (L, H*hd, D)        TP on the head-flat input dim
    mlp w_gate/up      (L, D, F)           TP on F
    mlp w_down         (L, F, D)           TP on F
    moe w_*            (L, E, D, F)        EP on E + FSDP on D (the 671B case)
    mamba/xlstm projs  (L, D, K)           FSDP/TP on K when divisible
Optimizer moments mirror their parameter's spec.  Batch: tokens shard over
(pod, data); caches shard batch and kv-heads.

The parameter rules and each rank's blocks (``PARAM_RULES``,
``spec_for_param``, ``param_shardings``, ``shard_tree``, ``gather_tree``)
live in :mod:`repro_torch.dist.blocks`, which the models, the optimizer and
checkpoints read, and are re-exported here; :func:`data_rows` picks the
rows of a global batch this rank's data coordinate trains on.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from ..dist.blocks import (PARAM_RULES, ShardedLayout, _block, _map_with_path,  # noqa: F401
                           _path_str, gather_leaf, gather_tree, leaf_specs, param_shardings,
                           shard_leaf, shard_tree, spec_axes, spec_for_param)
from ..dist.sharding import extent, resolve_axis


def batch_shardings(mesh, batch, rules) -> Any:
    """tokens (B, S): batch over (pod, data); embeds (B, N, D) likewise.

    Batch dims that don't divide the DP extent stay replicated, as the
    reference's do (the train step raises on such a batch: see
    :func:`data_rows`)."""
    names = tuple(mesh.axis_names)
    dp = resolve_axis("batch", rules, names)
    dp_size = extent(mesh, dp)

    def leaf(_, t):
        nd = len(t.shape)
        b = t.shape[0] if nd else 0
        use_dp = dp if (nd and b % max(dp_size, 1) == 0) else None
        return (use_dp,) + (None,) * (nd - 1)

    return _map_with_path(leaf, batch)


def cache_shardings(mesh, state, rules) -> Any:
    """DecodeState: shard the batch dim; KV head dim over model when present.

    Cache layouts (leading L = stacked layer axis within a segment):
        KVCache.k/v      (L, B, S, K, hd)
        MLACache.c_kv    (L, B, S, R)
        Mamba2Cache.*    (L, B, ...)
        length           (L, B)
        cross_kv         (B, S_enc, D)  (no leading L)
    """
    names = tuple(mesh.axis_names)
    dp = resolve_axis("batch", rules, names)
    kvh = resolve_axis("kv_heads", rules, names)
    dp_size = extent(mesh, dp)
    kvh_size = extent(mesh, kvh)

    def leaf(path, t):
        shape, nd, name = tuple(t.shape), len(t.shape), _path_str(path)

        def dp_for(i):
            return dp if shape[i] % max(dp_size, 1) == 0 else None

        def kvh_for(i):
            return kvh if shape[i] % max(kvh_size, 1) == 0 else None

        if re.search(r"(^|/)(k|v)$", name) and nd == 5:  # stacked (L,B,S,K,hd)
            return (None, dp_for(1), None, kvh_for(3), None)
        if re.search(r"(^|/)(k|v)$", name) and nd == 4:  # shared block (B,S,K,hd)
            return (dp_for(0), None, kvh_for(2), None)
        if "cross_kv" in name and nd == 3:
            return (dp_for(0), None, None)
        if nd >= 2:
            return (None, dp_for(1)) + (None,) * (nd - 2)
        return (None,)

    return _map_with_path(leaf, state)


def train_state_shardings(mesh, state, rules) -> Any:
    """TrainState(params, opt(mu, nu, count), step): moments mirror params."""
    names = tuple(mesh.axis_names)

    def leaf(path, t):
        name = _path_str(path)
        # strip TrainState/Adam prefixes so PARAM_RULES regexes match
        stripped = re.sub(r"^(params|opt/mu|opt/nu)/", "", name)
        if stripped in ("step", "count") or name.endswith(("/count", "step")):
            return ()
        return spec_for_param(stripped, len(t.shape), rules, names)

    return _map_with_path(leaf, state)


def data_rows(batch: Dict[str, torch.Tensor], mesh, rules,
              microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """The rows of a global batch (every leaf (B, ...)) this rank trains
    on: its data coordinate's block of every microbatch, so that its
    microbatch ``i`` is its part of the global rows ``[i B / m, (i + 1) B
    / m)``, the reference's microbatch ``i`` (one block of B / D rows when
    ``microbatches`` is 1, ``batch_shardings``' layout).  ``ValueError``
    unless the data ranks times ``microbatches`` divide B: a batch the
    reference would replicate over ``data`` is not trained here."""
    dp = resolve_axis("batch", rules, tuple(mesh.axis_names))
    n, i = _block(mesh, dp)

    def rows(t):
        b = t.shape[0]
        if b % (n * microbatches):
            raise ValueError(f"a batch of {b} rows does not split into {microbatches} "
                             f"microbatch(es) over {n} data rank(s)")
        per = b // (n * microbatches)
        micro = t.reshape((microbatches, n, per) + tuple(t.shape[1:]))
        return micro[:, i].reshape((microbatches * per,) + tuple(t.shape[1:]))

    return {k: rows(v) for k, v in batch.items()}


def init_sharded_train_state(gen: torch.Generator, cfg, opt_cfg, mesh, rules, device=None):
    """The one-rank run's initial TrainState from ``gen`` (the same draws
    in the same order), each parameter cut to this rank's block and the
    global copy freed, zero moments of the blocks, step 0."""
    from ..models import lm
    from ..models import steps as steps_mod
    from ..optim import adamw

    params = lm.init_params(gen, cfg, device=device)
    params = shard_tree(params, param_shardings(mesh, params, rules), mesh)
    dev = next(lm.tree_leaves(params)).device
    return steps_mod.TrainState(params=params, opt=adamw.init(params, opt_cfg),
                                step=torch.zeros((), dtype=torch.int32, device=dev))
