"""The decoder-only LM: layer stack, caches, forward, prefill and decode.

Port of ``repro/models/lm.py`` for the ``transformer`` block type with GQA
attention: ``dense`` layers and ``moe`` layers (:mod:`.moe`), the five
configs of ``repro_torch.configs``.  The parameters are a dict of tensors
mirroring the reference's tree: ``embed`` (``table``, and ``unembed``
unless tied), ``final_norm`` and ``segments``, one dict per run of
same-kind layers with every leaf stacked along a leading layer axis.  The
reference's ``lax.scan`` over that axis becomes a Python loop over it, and
its ``jax.checkpoint`` of each layer (``cfg.remat``) becomes
``torch.utils.checkpoint`` wherever grad is enabled: a training step keeps
each layer's input and recomputes the rest in the backward pass.  Each
layer's aux loss (an MoE layer's Switch loss, a dense layer's 0) is summed.
MLA, ``mamba2``, ``mlstm`` and ``slstm`` layers, image embeddings and
encoder frames raise ``NotImplementedError`` (ROADMAP.md Queue 1 items
11.3-11.6).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import apply_norm, embed, init_embedding, init_mlp, init_norm, mlp, unembed

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1 item 11)"


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _require_kind(kind: str) -> None:
    if kind not in ("dense", "moe"):
        raise NotImplementedError(f"the {kind!r} layer kind {_NOT_PORTED}")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.block_type != "transformer" or cfg.attn_type != "gqa" or cfg.is_encdec \
            or not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name}: block_type={cfg.block_type!r}, attn_type={cfg.attn_type!r}, "
            f"is_encdec={cfg.is_encdec}, use_rope={cfg.use_rope} {_NOT_PORTED}; the port "
            "runs decoder-only transformers with GQA and RoPE, dense or MoE"
        )
    for kind in cfg.layer_kinds():
        _require_kind(kind)


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
    _require_kind(kind)
    dt, d = _pdtype(cfg), cfg.d_model
    p = {
        "ln1": init_norm(d, dt, gen.device),
        "ln2": init_norm(d, dt, gen.device),
        "attn": attn_mod.init_gqa(gen, cfg, dt),
    }
    if kind == "dense":
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dt, cfg.mlp_variant)
    else:
        p["moe"] = moe_mod.init_moe(gen, cfg, dt)
    return p


def _ffn(params: dict, kind: str, cfg: ModelConfig,
         h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's feed-forward half on normed ``h`` -> (y, aux_loss); a
    dense layer's aux loss is 0."""
    if kind == "dense":
        return mlp(params["mlp"], h, cfg.act), torch.zeros((), dtype=torch.float32,
                                                           device=h.device)
    return moe_mod.moe_ffn(params["moe"], cfg, h, cfg.act)


def _layer_forward(params: dict, kind: str, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x, aux_loss)."""
    _require_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    x = x + attn_mod.gqa_forward(params["attn"], cfg, h, positions, rope=cfg.use_rope)
    h = apply_norm(params["ln2"], x, cfg.norm_type, cfg.norm_eps)
    y, aux = _ffn(params, kind, cfg, h)
    return x + y, aux


def _layer_decode(params: dict, kind: str, cfg: ModelConfig, x: torch.Tensor,
                  cache: attn_mod.KVCache) -> Tuple[torch.Tensor, attn_mod.KVCache]:
    """One position through a layer; an MoE layer routes the B tokens of
    this step alone (capacity from B), as the reference does."""
    _require_kind(kind)
    h = apply_norm(params["ln1"], x, cfg.norm_type, cfg.norm_eps)
    a, cache = attn_mod.gqa_decode(params["attn"], cfg, h, cache, rope=cfg.use_rope)
    x = x + a
    h = apply_norm(params["ln2"], x, cfg.norm_type, cfg.norm_eps)
    return x + _ffn(params, kind, cfg, h)[0], cache


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
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, seg in enumerate(segments_of(cfg)):
        for i in range(seg.n):
            args = (_layer(params["segments"][si], i), seg.kind, cfg, x, positions)
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
    """Per-layer caches grouped by segment (stacked along the layer axis)."""

    segments: Tuple[Any, ...]  # the reference's zamba / encoder-decoder fields: not ported


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cross_kv: Optional[torch.Tensor] = None, device=None) -> DecodeState:
    if cross_kv is not None:
        raise NotImplementedError(f"encoder memory {_NOT_PORTED}")
    _require_ported(cfg)
    device = resolve_device(device)
    dt = _dtype(cfg)
    seg_caches = []
    for seg in segments_of(cfg):
        one = attn_mod.init_kv_cache(cfg, batch, max_len, dt, device)
        seg_caches.append(attn_mod.KVCache(*(torch.stack([a] * seg.n) for a in one)))
    return DecodeState(segments=tuple(seg_caches))


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One token in (B, 1) -> logits (B, vocab_padded), updated caches; the
    parameters are cast to the compute dtype here, as the reference does.

    The caches are written in place (:func:`attention.gqa_decode`): the
    returned state shares its key and value tensors with ``state``, so a
    state once decoded from sees the next token's keys and values too.  A
    full cache (``max_len`` positions) raises ``ValueError``; the reference
    overwrites its last position instead."""
    return decode_step_precast(cast_params(params, cfg), cfg, tokens, state)


def decode_step_precast(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                        state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """:func:`decode_step` on parameters already cast by :func:`cast_params`."""
    for seg_cache in state.segments:
        max_len = seg_cache.k.shape[2]  # (layers, B, max_len, KH, Dh)
        if int(seg_cache.length.max()) >= max_len:
            raise ValueError(f"decode_step: the KV cache is full ({max_len} positions, the "
                             "max_len given to init_decode_state)")
    x = _embed_scaled(params, cfg, tokens)
    new_seg_caches = []
    for si, seg in enumerate(segments_of(cfg)):
        seg_cache = state.segments[si]
        for i in range(seg.n):
            layer_cache = attn_mod.KVCache(seg_cache.k[i], seg_cache.v[i], seg_cache.length[i])
            x, _ = _layer_decode(_layer(params["segments"][si], i), seg.kind, cfg, x,
                                 layer_cache)
        new_seg_caches.append(seg_cache._replace(length=seg_cache.length + 1))
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = logits_for(params, cfg, x)[:, 0]
    return logits, DecodeState(segments=tuple(new_seg_caches))
