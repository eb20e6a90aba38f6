"""Mixture-of-Experts FFN: top-k routing, shared experts, capacity dispatch.

Port of ``repro/models/moe.py``.  Dispatch is capacity-based
(drop-on-overflow) via sort-free cumulative positioning: tokens pick
experts, each (token, choice) computes its slot in the expert's buffer by a
masked cumsum over the flattened (T * k) choices, and slots beyond capacity
go to a scratch row (Switch/GShard semantics, ``capacity_factor``).  The
experts run as batched products over the (E, cap + 1, D) buffers.

The router is float32 and supports DeepSeek's aux-loss-free bias balancing:
``router_bias`` is added to the routing logits only for selection, never to
the combine weights, so no gradient reaches it (it moves only through
:func:`update_router_bias`, which, as in the reference, no train step
calls).  The Switch load-balancing loss is computed and returned.

:func:`moe_ffn` is :func:`_routing` followed by :func:`expert_ffn`, which
takes the routing (``idx``, ``gates``) as given, so that the dispatch, the
experts and the combine can be held with the routing pinned.  The
reference's scatter-adds become ``index_put`` with ``accumulate=True`` for
the dispatch (a kept slot receives exactly one token, so it is exact) and,
for the combine, a sum over each token's k rows (the reference's
``tok_ids`` is ``repeat(arange(T), k)``), which needs no atomics.

Under active sharding rules (:mod:`repro_torch.dist.sharding`) the layer
keeps the reference's global semantics, which GSPMD gives it there:

* a data rank routes its own tokens, then gathers the expert ids of every
  data rank (in data order, the global batch's token order), so that the
  capacity (:func:`capacity` of the global token count), each (token,
  choice)'s slot (:func:`dispatch_slots`) and so each drop are the
  one-rank layer's; its share of the aux loss is its tokens' part of the
  global router-probability mean against the global expert counts, so the
  shares sum over the data axis to the one-rank aux;
* a model rank holds ``E / M`` experts (``experts`` on ``model``) and runs
  its data rank's (token, choice) pairs routed to them, each expert's
  rebased to start at slot 0 (they hold one contiguous range of its global
  slots), so that the buffers hold about ``capacity / D`` rows, not the
  global capacity; the combine is a partial sum over the model axis,
  reduced;
* an expert weight whose ``d_model`` is split over ``data`` (``fsdp``) is
  gathered whole for use (:func:`repro_torch.dist.sharding.fsdp_gather`),
  its gradient summed over the data ranks and cut back to the block.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import is_meta, static_bound
from ..dist import sharding
from .config import ModelConfig
from .layers import _activation, _truncated_normal, dense_init, init_mlp, mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, dff, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    std = d**-0.5
    p = {
        "router": dense_init(gen, d, e, torch.float32),  # router kept float32
        "router_bias": torch.zeros((e,), dtype=torch.float32, device=gen.device),
        "w_gate": _truncated_normal(gen, (e, d, dff), std, dtype),
        "w_up": _truncated_normal(gen, (e, d, dff), std, dtype),
        "w_down": _truncated_normal(gen, (e, dff, d), dff**-0.5, dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.d_ff_expert * cfg.n_shared_experts, dtype)
    return p


def _routing(params: dict, cfg: ModelConfig,
             x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (top-k expert ids (T, k), combine weights (T, k) in x's dtype,
    the Switch aux loss, a float32 scalar; on a data axis, this rank's
    share of the global batch's)."""
    logits = x2d.float() @ params["router"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    select = logits + params["router_bias"] if cfg.router_aux_free_bias else logits
    _, idx = torch.topk(select, cfg.top_k, dim=-1)  # (T, k), descending, as lax.top_k
    gates = torch.gather(probs, -1, idx)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance monitor: E * sum_e f_e * p_e, both means over
    # the global batch's tokens
    e = cfg.n_experts
    all_idx = sharding.data_gather(idx)
    me = probs.sum(dim=0) / all_idx.shape[0]
    ce = F.one_hot(all_idx, e).float().sum(dim=1).mean(dim=0) / cfg.top_k
    aux = e * torch.sum(me * ce)
    return idx, gates.to(x2d.dtype), aux


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens: the reference's expression."""
    return max(1, int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts))


def dispatch_slots(cfg: ModelConfig, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, k) expert ids -> (slot (T * k,), keep (T * k,)): each flattened
    (token, choice)'s position in its expert's buffer, first come first
    served in the flattened order, and whether it fits under the capacity;
    a dropped choice's slot is the scratch row ``cap``."""
    cap = capacity(cfg, idx.shape[0])
    # (E, T * k): the cumsum runs along the inner dim, which the card scans
    # in parallel (along the outer dim it walks the T * k rows in sequence)
    onehot = F.one_hot(idx.reshape(-1), cfg.n_experts).t().contiguous()
    slot = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(dim=0)
    keep = slot < cap
    return torch.where(keep, slot, cap), keep


def rebase_slots(cfg: ModelConfig, all_idx: torch.Tensor, slot: torch.Tensor,
                 keep: torch.Tensor, first: int) -> Tuple[torch.Tensor, int]:
    """A data rank's slots, the flat (token, choice) pairs ``[first, first +
    len(slot))`` of the global routing ``all_idx`` (T, k), rebased so that
    each expert's start at 0 -> (the slots, the buffer rows that the pairs
    in ``keep`` need).  An expert's slots fill in the global order, so the
    rank's kept pairs of it hold one contiguous range after the earlier
    ranks' pairs: the rows are about ``capacity / D`` over D data ranks, at
    most the capacity.  Reading the rows is a host sync.  On ``meta`` (a
    dry run) the slots stay global and the rows are the global capacity:
    the buffers the reference allocates."""
    if is_meta(slot):
        cap = capacity(cfg, all_idx.shape[0])
        static_bound("models/moe.py:rebase_slots",
                     f"expert buffer rows = the global capacity {cap}, as the reference allocates")
        return slot, cap
    flat = all_idx.reshape(-1)
    before = torch.bincount(flat[:first], minlength=cfg.n_experts)
    slot = slot - before[flat[first:first + slot.numel()]]
    return slot, int(torch.where(keep, slot + 1, 0).max())


def expert_ffn(params: dict, cfg: ModelConfig, x2d: torch.Tensor, idx: torch.Tensor,
               gates: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The routed experts of (T, D) tokens under a given routing (``idx``
    and ``gates``, (T, k)): dispatch into (E, cap + 1, D) buffers (on a
    mesh, this rank's experts and rows), the experts' GLU, and the
    gate-weighted combine, (T, D).  No shared expert."""
    t, d = x2d.shape
    k = cfg.top_k
    # the global routing: every data rank's ids, this rank's rows of the slots
    all_idx = sharding.data_gather(idx)
    slot, keep = dispatch_slots(cfg, all_idx)
    rows = capacity(cfg, all_idx.shape[0])
    first = sharding.split("batch")[1] * t * k
    slot, keep = slot[first:first + t * k], keep[first:first + t * k]
    # this rank's experts [e0, e0 + e): the choices routed elsewhere go to
    # the scratch row and come back as zeros
    e, e0 = sharding.local_block(cfg.n_experts, "experts", "moe/w_gate")
    ep = e != cfg.n_experts
    if params["w_gate"].shape[0] != e:
        raise ValueError(f"{cfg.name}: {params['w_gate'].shape[0]} experts in this rank's "
                         f"block, but the active rules give it {e}")
    flat = idx.reshape(-1)
    keep = keep & (flat >= e0) & (flat < e0 + e)
    if all_idx.shape[0] != t:  # a data axis: this rank's rows, not the global capacity
        slot, rows = rebase_slots(cfg, all_idx, slot, keep, first)
    flat_e, slot = torch.where(keep, flat - e0, 0), torch.where(keep, slot, rows)
    if ep:
        x2d, gates = sharding.grad_reduce_boundary(x2d), sharding.grad_reduce_boundary(gates)

    # dispatch: (E, rows + 1, D) buffers, the + 1 scratch row swallowing drops
    tok_ids = torch.arange(t, device=x2d.device).repeat_interleave(k)
    buf = x2d.new_zeros((e, rows + 1, d)).index_put((flat_e, slot), x2d[tok_ids],
                                                    accumulate=True)

    # the experts: batched products over the expert dim
    actfn = _activation(act)
    w_gate = sharding.fsdp_gather(params["w_gate"], 1)
    w_up = sharding.fsdp_gather(params["w_up"], 1)
    w_down = sharding.fsdp_gather(params["w_down"], 2)
    gate = torch.einsum("ecd,edf->ecf", buf, w_gate)
    up = torch.einsum("ecd,edf->ecf", buf, w_up)
    out_buf = torch.einsum("ecf,efd->ecd", actfn(gate) * up, w_down)

    # combine: gather the slots back, weight by the gates, sum each token's k rows
    gathered = torch.where(keep[:, None], out_buf[flat_e, slot], 0.0)
    out = (gathered * gates.reshape(-1, 1)).view(t, k, d).sum(dim=1)
    return sharding.constrain(out) if ep else out


def moe_ffn(params: dict, cfg: ModelConfig, x: torch.Tensor,
            act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (same, aux_loss).  Capacity-dropped top-k dispatch."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    idx, gates, aux = _routing(params, cfg, x2d)
    out = expert_ffn(params, cfg, x2d, idx, gates, act).reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + mlp(params["shared"], x, act)
    return out, aux


def update_router_bias(params: dict, cfg: ModelConfig, aux_counts: torch.Tensor,
                       lr: float = 1e-3) -> dict:
    """DeepSeek aux-free balancing: nudge the biases toward uniform expert load.

    ``aux_counts``: (E,) fraction of tokens routed to each expert this step.
    Outside grad: the bias is a buffer, not a trained parameter.  Returns a
    new dict; ``params`` is left as it is."""
    target = 1.0 / cfg.n_experts
    new_bias = params["router_bias"] + lr * torch.sign(target - aux_counts)
    return dict(params, router_bias=new_bias)
