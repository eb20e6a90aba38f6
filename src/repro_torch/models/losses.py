"""Losses: sequence-chunked cross-entropy over a padded vocabulary.

Port of ``repro/models/losses.py``.  The LM head is the memory cliff of the
big-vocabulary archs: at minitron's V = 256000, B = 4 and 2048 tokens, the
float32 logits would be 8.4 GB.  They are never formed whole: the head runs
over sequence chunks of ``cfg.loss_chunk`` tokens, each computing logits ->
log-softmax -> NLL and reducing to scalars.  The reference's ``lax.scan``
with ``jax.checkpoint`` becomes a Python loop whose chunks each run under a
non-reentrant ``torch.utils.checkpoint`` when grad is enabled, so the
backward pass recomputes a chunk's logits instead of storing them: at most
one (B, loss_chunk, V) logit block is alive (2.1 GB at chunk 512).

Under active sharding rules (:mod:`repro_torch.dist.sharding`) the head is
vocab-parallel: a rank holds its block of the logits, the logsumexp comes
from a max and a sum of exponentials each reduced over the model axis, the
target's logit from the rank that owns its id, the accuracy from the
argmax across the blocks (the largest value, then the lowest id among the
blocks that hold it: ``argmax``'s first maximum), and the pad mask reads
each column's global id.  On a data axis of D ranks each rank's values are
its share of the global batch's mean (its sums over D x its tokens), so
that their sum over the data axis is the one-rank value.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..dist import sharding
from .config import ModelConfig
from .layers import unembed


def _chunk_nll(params: dict, cfg: ModelConfig, h_chunk: torch.Tensor,
               t_chunk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sum NLL over the chunk, sum of correct-token counts), float32.

    The float32 embedding leaves are cast to the hidden states' dtype here,
    inside the chunk, as the reference does."""
    table = {k: v.to(h_chunk.dtype) if v.dtype == torch.float32 else v
             for k, v in params["embed"].items()}
    logits = unembed(table, h_chunk, cfg.tie_embeddings).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    cols, v0 = sharding.local_block(cfg.vocab_padded, "vocab", "the LM head")
    if logits.shape[-1] != cols:
        raise ValueError(f"{cfg.name}: {logits.shape[-1]} logits a position, but the active "
                         f"rules give this rank {cols} of the {cfg.vocab_padded} vocabulary rows")
    ids = v0 + torch.arange(cols, device=logits.device)  # each column's global id
    if cfg.vocab_padded != cfg.vocab:
        # padded vocab rows exist only for sharding; mask them out of the softmax
        logits = logits.masked_fill(ids >= cfg.vocab, -1e30)
    t_chunk = t_chunk.long()
    if cols == cfg.vocab_padded:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, t_chunk[..., None])[..., 0]
        acc = (torch.argmax(logits, dim=-1) == t_chunk).float()
        return (lse - tgt).sum(), acc.sum()
    local_max, local_arg = logits.detach().max(dim=-1)  # the first maximum in the block
    m = sharding.reduce_max(local_max)
    lse = m + torch.log(sharding.constrain(torch.exp(logits - m[..., None]).sum(dim=-1)))
    local_t = t_chunk - v0
    mine = (local_t >= 0) & (local_t < cols)
    tgt = torch.gather(logits, -1, torch.where(mine, local_t, 0)[..., None])[..., 0]
    tgt = sharding.constrain(torch.where(mine, tgt, 0.0))
    # argmax across the blocks: the largest value, then the lowest global id holding it
    holder = torch.where(local_max == m, v0 + local_arg, cfg.vocab_padded)
    acc = (sharding.reduce_min(holder) == t_chunk).float()
    return (lse - tgt).sum(), acc.sum()


def chunked_cross_entropy(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
                          targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden: (B, S, D), targets: (B, S) -> (mean NLL, mean accuracy),
    float32 (on a data axis, this rank's share of the global means); the
    ragged remainder of S past the last whole chunk is one
    more (unchecked) chunk, as in the reference."""
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk, s)
    n = s // chunk
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    acc_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    remat = torch.is_grad_enabled()
    for i in range(n):
        args = (params, cfg, hidden[:, i * chunk:(i + 1) * chunk],
                targets[:, i * chunk:(i + 1) * chunk])
        nll, acc = checkpoint(_chunk_nll, *args, use_reentrant=False) if remat \
            else _chunk_nll(*args)
        nll_sum, acc_sum = nll_sum + nll, acc_sum + acc
    if s > n * chunk:
        nll, acc = _chunk_nll(params, cfg, hidden[:, n * chunk:], targets[:, n * chunk:])
        nll_sum, acc_sum = nll_sum + nll, acc_sum + acc
    count = b * s * sharding.split("batch")[0]
    return nll_sum / count, acc_sum / count
