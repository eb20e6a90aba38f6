"""The decoder-only LM: layer stack, caches, forward, prefill and decode.

Port of ``repro/models/lm.py`` for its decoder-only models: ``transformer``
blocks of ``dense`` and ``moe`` layers (:mod:`.moe`) over GQA or MLA
attention (:mod:`.attention`), zamba2's hybrid of ``mamba2`` layers
(:mod:`.ssm`) with one shared attention + MLP block applied after every
``attn_every``-th layer, and xLSTM's ``mlstm`` / ``slstm`` layers
(:mod:`.xlstm`, no FFN).  The parameters are a dict of tensors mirroring the
reference's tree: ``embed`` (``table``, and ``unembed`` unless tied),
``final_norm``, ``segments``, one dict per run of same-kind layers with
every leaf stacked along a leading layer axis, and zamba2's
``shared_attn``.  The reference's ``lax.scan`` over that axis becomes a
Python loop over it, and its ``jax.checkpoint`` of each layer
(``cfg.remat``) becomes ``torch.utils.checkpoint`` wherever grad is
enabled: a training step keeps each layer's input and recomputes the rest
in the backward pass.  Each layer's aux loss (an MoE layer's Switch loss,
0 elsewhere) is summed.  Image embeddings, encoder frames and absolute
positions (``use_rope=False``) raise ``NotImplementedError`` (ROADMAP.md
Queue 1 item 11.6).

zamba2's decode carries one shared ``KVCache`` through the layers, as the
reference does: every invocation of the shared block appends a position to
it, so a token spends ``ceil(n_layers / attn_every)`` positions of it and
each invocation attends over the keys of every invocation.  That is the
reference's behaviour (a fault of the reference, ROADMAP.md Queue 3), and
the port keeps it: its decode does not agree with its prefill.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .config import ModelConfig
from .layers import apply_norm, embed, init_embedding, init_mlp, init_norm, mlp, unembed

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1 item 11.6)"


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.is_encdec or cfg.n_img_tokens or not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name}: is_encdec={cfg.is_encdec}, n_img_tokens={cfg.n_img_tokens}, "
            f"use_rope={cfg.use_rope} {_NOT_PORTED}; the port runs decoder-only models "
            "with RoPE and no image prefix"
        )


def _has_shared_attn(cfg: ModelConfig) -> bool:
    return cfg.block_type == "mamba2" and bool(cfg.attn_every)


def shared_invocations(cfg: ModelConfig) -> int:
    """How often one token runs zamba2's shared block:
    ``ceil(n_layers / attn_every)``, the positions it takes of the shared
    cache (0 without a shared block)."""
    return -(-cfg.n_layers // cfg.attn_every) if _has_shared_attn(cfg) else 0


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_items(tree, path=()):
    """``(path, leaf)`` for the tensor leaves of nested dicts, lists and
    tuples, in order; a path is the tuple of keys and indices to its leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree):
    """The tensor leaves of nested dicts, lists and tuples, in order."""
    return (leaf for _, leaf in tree_items(tree))


# ---------------------------------------------------------------------------
# per-layer init / forward / decode
# ---------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig) -> dict:
    dt, d = _pdtype(cfg), cfg.d_model
    if kind in ("dense", "moe"):
        p = {"ln1": init_norm(d, dt, gen.device), "ln2": init_norm(d, dt, gen.device)}
        if cfg.attn_type == "mla":
            p["attn"] = attn_mod.init_mla(gen, cfg, dt)
        else:
            p["attn"] = attn_mod.init_gqa(gen, cfg, dt)
        if kind == "dense":
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, dt, cfg.mlp_variant)
        else:
            p["moe"] = moe_mod.init_moe(gen, cfg, dt)
        return p
    if kind == "mamba2":
        return {"ln": init_norm(d, dt, gen.device), "mamba": ssm_mod.init_mamba2(gen, cfg, dt)}
    if kind == "mlstm":
        return {"ln": init_norm(d, dt, gen.device), "mlstm": xlstm_mod.init_mlstm(gen, cfg, dt)}
    if kind == "slstm":
        return {"ln": init_norm(d, dt, gen.device), "slstm": xlstm_mod.init_slstm(gen, cfg, dt)}
    raise ValueError(kind)


def _ffn(params: dict, kind: str, cfg: ModelConfig,
         h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's feed-forward half on normed ``h`` -> (y, aux_loss); a
    dense layer's aux loss is 0."""
    if kind == "dense":
        return mlp(params["mlp"], h, cfg.act), _zero(h)
    return moe_mod.moe_ffn(params["moe"], cfg, h, cfg.act)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _shared_block(shared: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """zamba2's shared attention + MLP block over a whole sequence."""
    h = apply_norm(shared["ln1"], x, cfg.norm_type, cfg.norm_eps)
    x = x + attn_mod.gqa_forward(shared["attn"], cfg, h, positions)
    h = apply_norm(shared["ln2"], x, cfg.norm_type, cfg.norm_eps)
    return x + mlp(shared["mlp"], h, cfg.act)


def _applies_shared(cfg: ModelConfig, shared: Optional[dict], layer_idx: int) -> bool:
    """The shared block runs after global layer ``layer_idx`` when
    ``layer_idx % attn_every == 0``."""
    return shared is not None and bool(cfg.attn_every) and layer_idx % cfg.attn_every == 0


def _layer_forward(params: dict, kind: str, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, shared: Optional[dict] = None,
                   layer_idx: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x, aux_loss); ``layer_idx`` is the global index of the layer."""
    if kind in ("dense", "moe"):
        h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
        if cfg.attn_type == "mla":
            x = x + attn_mod.mla_forward(params["attn"], cfg, h, positions)
        else:
            x = x + attn_mod.gqa_forward(params["attn"], cfg, h, positions, rope=cfg.use_rope)
        h = apply_norm(params["ln2"], x, cfg.norm_type, cfg.norm_eps)
        y, aux = _ffn(params, kind, cfg, h)
        return x + y, aux
    if kind == "mamba2":
        h = apply_norm(params["ln"], x, cfg.norm_type, cfg.norm_eps)
        x = x + ssm_mod.mamba2_forward(params["mamba"], cfg, h)
        if _applies_shared(cfg, shared, layer_idx):
            x = _shared_block(shared, cfg, x, positions)
        return x, _zero(x)
    if kind == "mlstm":
        h = apply_norm(params["ln"], x, cfg.norm_type, cfg.norm_eps)
        return x + xlstm_mod.mlstm_forward(params["mlstm"], cfg, h), _zero(x)
    if kind == "slstm":
        h = apply_norm(params["ln"], x, cfg.norm_type, cfg.norm_eps)
        return x + xlstm_mod.slstm_forward(params["slstm"], cfg, h), _zero(x)
    raise ValueError(kind)


def _init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    if kind in ("dense", "moe"):
        if cfg.attn_type == "mla":
            return attn_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
        return attn_mod.init_kv_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba2":
        return ssm_mod.init_mamba2_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm_mod.init_mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return xlstm_mod.init_slstm_cache(cfg, batch, device)
    raise ValueError(kind)


def _layer_decode(params: dict, kind: str, cfg: ModelConfig, x: torch.Tensor, cache,
                  shared: Optional[dict] = None, shared_cache=None, layer_idx: int = 0):
    """One position through a layer -> (x, its new cache, the new shared
    cache).  An MoE layer routes the B tokens of this step alone (capacity
    from B), as the reference does; an attention cache is written in place,
    a recurrent one comes back new."""
    if kind in ("dense", "moe"):
        h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
        if cfg.attn_type == "mla":
            decode_fn = (attn_mod.mla_decode_absorbed if cfg.mla_absorbed
                         else attn_mod.mla_decode)
            a, cache = decode_fn(params["attn"], cfg, h, cache)
        else:
            a, cache = attn_mod.gqa_decode(params["attn"], cfg, h, cache, rope=cfg.use_rope)
        x = x + a
        h = apply_norm(params["ln2"], x, cfg.norm_type, cfg.norm_eps)
        return x + _ffn(params, kind, cfg, h)[0], cache, shared_cache
    if kind == "mamba2":
        h = apply_norm(params["ln"], x, cfg.norm_type, cfg.norm_eps)
        y, cache = ssm_mod.mamba2_decode(params["mamba"], cfg, h, cache)
        x = x + y
        if _applies_shared(cfg, shared, layer_idx):
            h = apply_norm(shared["ln1"], x, cfg.norm_type, cfg.norm_eps)
            a, shared_cache = attn_mod.gqa_decode(shared["attn"], cfg, h, shared_cache)
            x = x + a
            h = apply_norm(shared["ln2"], x, cfg.norm_type, cfg.norm_eps)
            x = x + mlp(shared["mlp"], h, cfg.act)
        return x, cache, shared_cache
    if kind == "mlstm":
        h = apply_norm(params["ln"], x, cfg.norm_type, cfg.norm_eps)
        y, cache = xlstm_mod.mlstm_decode(params["mlstm"], cfg, h, cache)
        return x + y, cache, shared_cache
    if kind == "slstm":
        h = apply_norm(params["ln"], x, cfg.norm_type, cfg.norm_eps)
        y, cache = xlstm_mod.slstm_decode(params["slstm"], cfg, h, cache)
        return x + y, cache, shared_cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


class Segment(NamedTuple):
    kind: str
    n: int
    start: int  # absolute index of first layer


def segments_of(cfg: ModelConfig) -> List[Segment]:
    kinds = cfg.layer_kinds()
    segs: List[Segment] = []
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        segs.append(Segment(kind=kinds[i], n=j - i, start=i))
        i = j
    return segs


def _stack_layers(gen: torch.Generator, kind: str, n: int, cfg: ModelConfig) -> dict:
    return _stack([_init_layer(gen, kind, cfg) for _ in range(n)])


def _stack(trees: list):
    """Same-shaped dicts of tensors -> one dict of tensors stacked on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(seg_params: dict, i: int) -> dict:
    """Layer ``i`` of a stacked segment (views, no copy)."""
    return tree_map(lambda a: a[i], seg_params)


# ---------------------------------------------------------------------------
# full decoder stack
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Parameters in ``cfg.param_dtype``, drawn on the generator's device
    (truncated normals, as the reference) and placed on ``device``."""
    _require_ported(cfg)
    device = resolve_device(device)
    dt = _pdtype(cfg)
    p: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dt, cfg.tie_embeddings),
        "final_norm": init_norm(cfg.d_model, dt, gen.device),
        "segments": [_stack_layers(gen, seg.kind, seg.n, cfg) for seg in segments_of(cfg)],
    }
    if _has_shared_attn(cfg):
        d, dev = cfg.d_model, gen.device
        p["shared_attn"] = {
            "ln1": init_norm(d, dt, dev),
            "ln2": init_norm(d, dt, dev),
            "attn": attn_mod.init_gqa(gen, cfg, dt),
            "mlp": init_mlp(gen, d, cfg.d_ff, dt, cfg.mlp_variant),
        }
    return tree_map(lambda a: a.to(device), p)


def backbone_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all segments.  x: (B, S, D) embedded input.  -> (hidden, aux).

    Under ``cfg.remat`` with grad enabled each layer runs under a
    non-reentrant ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint(body)``): only its input is kept, and its forward runs
    again in the backward pass.  With grad off (prefill, decode) it runs
    once."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = _zero(x)
    shared = params.get("shared_attn")
    for si, seg in enumerate(segments_of(cfg)):
        for i in range(seg.n):
            args = (_layer(params["segments"][si], i), seg.kind, cfg, x, positions, shared,
                    seg.start + i)
            if remat:
                x, aux = checkpoint(_layer_forward, *args, use_reentrant=False)
            else:
                x, aux = _layer_forward(*args)
            aux_total = aux_total + aux
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return x, aux_total


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """Weights in float32 cast to the compute dtype; others (and weights
    already in it) kept as they are, without a copy."""
    dt = _dtype(cfg)
    return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32 else a, params)


def _embed_scaled(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    dt = _dtype(cfg)
    x = embed(params["embed"], tokens, dt)
    # gemma/whisper-style scale, kept for every arch as the reference does;
    # the factor is rounded to the compute dtype first, as jnp.asarray(.., dt)
    return x * torch.tensor(cfg.d_model**0.5, dtype=dt)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            img_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token stream (B, S) -> final hidden states (B, S, D), aux loss; the
    parameters are cast to the compute dtype here, as the reference does."""
    return forward_precast(cast_params(params, cfg), cfg, tokens, img_embeds, frames)


def forward_precast(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    img_embeds: Optional[torch.Tensor] = None,
                    frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` on parameters already cast by :func:`cast_params`."""
    if img_embeds is not None or frames is not None:
        raise NotImplementedError(f"image embeddings and encoder frames {_NOT_PORTED}")
    _require_ported(cfg)
    x = _embed_scaled(params, cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return backbone_forward(params, cfg, x, positions)


def logits_for(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    logits = unembed(params["embed"], hidden, cfg.tie_embeddings)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# ----- caches ---------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per-layer caches grouped by segment (stacked along the layer axis),
    and zamba2's shared-block KV cache (None without a shared block).  The
    reference's encoder memory (``cross_kv``) is not ported."""

    segments: Tuple[Any, ...]
    shared_attn: Any = None


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cross_kv: Optional[torch.Tensor] = None, device=None) -> DecodeState:
    """Empty caches for ``batch`` sequences.  ``max_len`` is the positions
    of each attention cache; zamba2's shared cache spends
    :func:`shared_invocations` positions a token, so it holds ``max_len //
    shared_invocations(cfg)`` tokens."""
    if cross_kv is not None:
        raise NotImplementedError(f"encoder memory {_NOT_PORTED}")
    _require_ported(cfg)
    device = resolve_device(device)
    dt = _dtype(cfg)
    seg_caches = []
    for seg in segments_of(cfg):
        one = _init_layer_cache(seg.kind, cfg, batch, max_len, dt, device)
        seg_caches.append(type(one)(*(torch.stack([a] * seg.n) for a in one)))
    shared = (attn_mod.init_kv_cache(cfg, batch, max_len, dt, device)
              if _has_shared_attn(cfg) else None)
    return DecodeState(segments=tuple(seg_caches), shared_attn=shared)


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One token in (B, 1) -> logits (B, vocab_padded), updated caches; the
    parameters are cast to the compute dtype here, as the reference does.

    Every cache is written in place (:func:`attention.gqa_decode`, the
    recurrent states copied back into their stacked tensors): the returned
    state shares its tensors with ``state``, so a state once decoded from
    sees the next token's keys, values and states too.  An attention cache
    without room for this token (``max_len`` positions; zamba2's shared one
    takes :func:`shared_invocations` a token) raises ``ValueError``; the
    reference overwrites its last position instead."""
    return decode_step_precast(cast_params(params, cfg), cfg, tokens, state)


def _cache_room(cfg: ModelConfig, state: DecodeState) -> None:
    """Raise ``ValueError`` unless every attention cache has room for this
    token; one host sync.  Recurrent caches have no positions to fill."""
    checks = []  # (what, filled positions, positions this token takes, max_len)
    for seg_cache in state.segments:
        if isinstance(seg_cache, attn_mod.KVCache):
            checks.append(("the KV cache", seg_cache.length.max(), 1, seg_cache.k.shape[2]))
        elif isinstance(seg_cache, attn_mod.MLACache):
            checks.append(("the MLA latent cache", seg_cache.length.max(), 1,
                           seg_cache.c_kv.shape[2]))
    if state.shared_attn is not None:
        checks.append(("the shared block's KV cache", state.shared_attn.length.max(),
                       shared_invocations(cfg), state.shared_attn.k.shape[1]))
    if not checks:
        return
    filled = torch.stack([c[1] for c in checks]).tolist()
    for (what, _, need, max_len), used in zip(checks, filled):
        if used + need > max_len:
            why = "" if need == 1 else (
                f"; {cfg.name} spends one position of it a token per invocation of the shared "
                f"block, {need} = ceil(n_layers / attn_every) = ceil({cfg.n_layers} / "
                f"{cfg.attn_every}), so max_len = {max_len} holds {max_len // need} tokens")
            raise ValueError(f"decode_step: {what} is full ({used} of {max_len} positions "
                             f"filled, the max_len given to init_decode_state){why}")


def decode_step_precast(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                        state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """:func:`decode_step` on parameters already cast by :func:`cast_params`."""
    _cache_room(cfg, state)
    x = _embed_scaled(params, cfg, tokens)
    shared, shared_cache = params.get("shared_attn"), state.shared_attn
    new_seg_caches = []
    for si, seg in enumerate(segments_of(cfg)):
        seg_cache = state.segments[si]
        for i in range(seg.n):
            layer_cache = type(seg_cache)(*(a[i] for a in seg_cache))
            x, new_cache, shared_cache = _layer_decode(
                _layer(params["segments"][si], i), seg.kind, cfg, x, layer_cache, shared,
                shared_cache, seg.start + i)
            for old, new in zip(layer_cache[:-1], new_cache[:-1]):  # all but the length
                if new is not old:  # a recurrent state: back into its stacked tensor
                    old.copy_(new)
        new_seg_caches.append(seg_cache._replace(length=seg_cache.length + 1))
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = logits_for(params, cfg, x)[:, 0]
    return logits, DecodeState(segments=tuple(new_seg_caches), shared_attn=shared_cache)
