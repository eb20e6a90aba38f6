"""The LM: layer stack, encoder, caches, forward, prefill and decode.

Port of ``repro/models/lm.py``: ``transformer`` blocks of ``dense`` and
``moe`` layers (:mod:`.moe`) over GQA or MLA attention (:mod:`.attention`),
zamba2's hybrid of ``mamba2`` layers (:mod:`.ssm`) with one shared
attention + MLP block applied after every ``attn_every``-th layer, xLSTM's
``mlstm`` / ``slstm`` layers (:mod:`.xlstm`, no FFN), Whisper's
encoder-decoder and pixtral's image prefix.  The parameters are a dict of
tensors mirroring the reference's tree: ``embed`` (``table``, and
``unembed`` unless tied), ``final_norm``, ``segments``, one dict per run of
same-kind layers with every leaf stacked along a leading layer axis,
zamba2's ``shared_attn``, and an encoder-decoder's ``encoder`` (``layers``,
stacked ``dense`` layers, and ``final_norm``) and ``cross`` (one ``ln`` and
one GQA ``attn`` a decoder layer, stacked).  The reference's ``lax.scan``
over that axis becomes a Python loop over it, and its ``jax.checkpoint`` of
each layer (``cfg.remat``) becomes ``torch.utils.checkpoint`` wherever grad
is enabled: a training step keeps each layer's input and recomputes the
rest in the backward pass.  Each layer's aux loss (an MoE layer's Switch
loss, 0 elsewhere) is summed.

Whisper: :func:`encoder_forward` adds the sinusoidal table to the frames
(the stubbed post-conv embeddings) and runs non-causal self-attention
without RoPE; its output is the source of every decoder layer's
cross-attention, which follows the layer's own block (inside the same
checkpoint under remat).  The decoder adds the sinusoidal table to its
scaled embeddings (``use_rope=False``).  Pixtral: ``img_embeds`` (B, N, D),
cast to the compute dtype and unscaled, go before the scaled token stream,
and the RoPE positions run over image plus text.

Sharded runs (:mod:`repro_torch.dist.sharding`): under active rules over a
mesh of more than one rank, the dense GQA stacks, the MoE layer, MLA
(deepseek-v3), Whisper's encoder-decoder, pixtral's text stack, the
Mamba-2 hybrid (zamba2) and xLSTM train,
prefill and decode on this rank's parameter blocks and batch rows, with the
collectives where the reference's ``constrain`` / ``grad_reduce_boundary``
sit (each tensor-parallel block: :func:`.layers.mlp`,
:func:`.attention.gqa_forward` and :func:`.attention.gqa_decode`, the MLA
functions, :func:`.moe.expert_ffn`, the embedding and the loss head).
Whisper's encoder and cross layers are :func:`.attention.gqa_forward` on
the rank's heads; the cross source (the encoder's output, and a decode's
``DecodeState.cross_kv``) is whole on every model rank, its rows the
rank's data rows.  The prefill and decode logits come from the
vocabulary-sharded ``unembed`` and are gathered whole over the model axis
(:func:`logits_for`), so each rank holds its rows' full logits and an
argmax over them breaks ties as one rank's does.  A decode cache holds the
rank's rows and its kv heads (all of them where ``kv_heads`` is not split:
``launch.partition.cache_shardings``); an MLA cache holds the rank's rows of
the whole latent.  Mamba-2 runs the rank's SSM heads
(:func:`.ssm.mamba2_forward`), and zamba2's shared block is the GQA
block's tensor parallelism on the shared parameters (its KV cache the
rank's kv heads); mLSTM runs the rank's column block of its heads and
sLSTM its recurrence whole on every model rank (:mod:`.xlstm`).  Their
recurrent caches are whole on every model rank (each the one-rank
cache), their rows the rank's data rows.

Two behaviours of the reference are kept, faults of the reference
(ROADMAP.md Queue 3), so the port's decode does not agree with its prefill
for these models:

* zamba2's decode carries one shared ``KVCache`` through the layers: every
  invocation of the shared block appends a position to it, so a token
  spends ``ceil(n_layers / attn_every)`` positions of it and each
  invocation attends over the keys of every invocation.
* Whisper's decode adds no position to the token it embeds (the prefill
  adds the sinusoidal table), and recomputes every layer's cross K / V from
  the encoder's output at every step.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import is_meta, resolve_device, static_bound
from ..dist import sharding
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .config import ModelConfig
from .layers import (
    apply_norm,
    embed,
    init_embedding,
    init_mlp,
    init_norm,
    mlp,
    sinusoidal_positions,
    unembed,
)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


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
    if cfg.is_encdec:
        p["encoder"] = {"layers": _stack_layers(gen, "dense", cfg.n_enc_layers, cfg),
                        "final_norm": init_norm(cfg.d_model, dt, gen.device)}
        p["cross"] = _stack([{"ln": init_norm(cfg.d_model, dt, gen.device),
                              "attn": attn_mod.init_gqa(gen, cfg, dt)}
                             for _ in range(cfg.n_layers)])
    return tree_map(lambda a: a.to(device), p)


def _block_forward(params: dict, cross: Optional[dict], kind: str, cfg: ModelConfig,
                   x: torch.Tensor, positions: torch.Tensor, shared: Optional[dict],
                   layer_idx: int,
                   cross_kv: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer, then its cross-attention layer when ``cross`` is given (an
    encoder-decoder's ``dense`` / ``moe`` layer) -> (x, aux_loss)."""
    x, aux = _layer_forward(params, kind, cfg, x, positions, shared, layer_idx)
    if cross is not None:
        x = _cross_one(cross, cfg, x, cross_kv)
    return x, aux


def backbone_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, cross_kv: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all segments.  x: (B, S, D) embedded input; ``cross_kv`` (B,
    S_enc, D) the encoder's output of an encoder-decoder.  -> (hidden, aux).

    Under ``cfg.remat`` with grad enabled each layer, its cross-attention
    layer included, runs under a non-reentrant ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint(body)``): only its input is kept, and
    its forward runs again in the backward pass.  With grad off (prefill,
    decode) it runs once."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = _zero(x)
    shared, cross = params.get("shared_attn"), params.get("cross")
    for si, seg in enumerate(segments_of(cfg)):
        for i in range(seg.n):
            idx = seg.start + i
            layer_cross = (_layer(cross, idx) if cross is not None and seg.kind in ("dense", "moe")
                           else None)
            args = (_layer(params["segments"][si], i), layer_cross, seg.kind, cfg, x, positions,
                    shared, idx, cross_kv)
            if remat:
                x, aux = checkpoint(_block_forward, *args, use_reentrant=False)
            else:
                x, aux = _block_forward(*args)
            aux_total = aux_total + aux
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return x, aux_total


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------


def _cross_one(layer: dict, cfg: ModelConfig, x: torch.Tensor,
               cross_kv: torch.Tensor) -> torch.Tensor:
    """One cross-attention layer: x (B, S, D) against the encoder's output,
    non-causal, no RoPE (S = 1 in decode)."""
    h = apply_norm(layer["ln"], x, cfg.norm_type, cfg.norm_eps)
    return x + attn_mod.gqa_forward(layer["attn"], cfg, h, None, causal=False, rope=False,
                                    kv=(cross_kv, None))


def _encoder_layer(layer: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(layer["ln1"], x, cfg.norm_type, cfg.norm_eps)
    x = x + attn_mod.gqa_forward(layer["attn"], cfg, h, None, causal=False, rope=False)
    h = apply_norm(layer["ln2"], x, cfg.norm_type, cfg.norm_eps)
    return x + mlp(layer["mlp"], h, cfg.act)


def encoder_forward(params: dict, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, D), the stubbed post-conv embeddings -> the encoder's
    output (B, S_enc, D) in the compute dtype, the source of the decoder's
    cross-attention; the parameters are cast to the compute dtype here, as
    the reference does."""
    return encoder_forward_precast(cast_params(params, cfg), cfg, frames)


def encoder_forward_precast(params: dict, cfg: ModelConfig,
                            frames: torch.Tensor) -> torch.Tensor:
    """:func:`encoder_forward` on parameters already cast by :func:`cast_params`:
    the frames plus the sinusoidal table, ``n_enc_layers`` dense layers of
    non-causal self-attention without RoPE (each under a checkpoint when
    ``cfg.remat`` and grad is enabled), the final norm."""
    frames = frames.to(_dtype(cfg))
    s, d = frames.shape[1:]
    x = frames + sinusoidal_positions(s, d, frames.device).to(frames.dtype)[None]
    enc = params["encoder"]
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_enc_layers):
        args = (_layer(enc["layers"], i), cfg, x)
        if remat:
            x = checkpoint(_encoder_layer, *args, use_reentrant=False)
        else:
            x = _encoder_layer(*args)
    return apply_norm(enc["final_norm"], x, cfg.norm_type, cfg.norm_eps)


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
    """Token stream (B, S) -> final hidden states (B, N + S, D), aux loss;
    ``img_embeds`` (B, N, D) go before the tokens, and an encoder-decoder
    config needs ``frames`` (B, S_enc, D), which :func:`encoder_forward`
    turns into the cross-attention source.  The parameters are cast to the
    compute dtype here, as the reference does."""
    return forward_precast(cast_params(params, cfg), cfg, tokens, img_embeds, frames)


def forward_precast(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    img_embeds: Optional[torch.Tensor] = None,
                    frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` on parameters already cast by :func:`cast_params`."""
    dt = _dtype(cfg)
    x = _embed_scaled(params, cfg, tokens)
    if img_embeds is not None:  # unscaled, before the text
        x = torch.cat([img_embeds.to(dt), x], dim=1)
    b, s, _ = x.shape
    if not cfg.use_rope:  # absolute sinusoidal positions (whisper's decoder)
        x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(dt)[None]
    positions = torch.arange(s, device=x.device).expand(b, s)
    cross_kv = None
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward needs frames (B, S_enc, "
                             f"{cfg.d_model}), the encoder's input")
        cross_kv = encoder_forward_precast(params, cfg, frames)
    return backbone_forward(params, cfg, x, positions, cross_kv)


def logits_for(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """The logits (..., vocab_padded) of ``hidden``.  Under rules that shard
    ``vocab`` the rank's block of them comes from its block of ``unembed``
    and the blocks are gathered whole over the model axis (the reference's
    GSPMD may keep them sharded; the port gives every model rank the whole
    row, so a greedy argmax needs no cross-rank tie-break)."""
    logits = unembed(params["embed"], hidden, cfg.tie_embeddings)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if sharding.split("vocab")[0] > 1:
        logits = sharding.model_gather(logits, dim=-1)
    return logits


# ----- caches ---------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per-layer caches grouped by segment (stacked along the layer axis),
    zamba2's shared-block KV cache (None without a shared block) and an
    encoder-decoder's encoder output (B, S_enc, D), the cross-attention
    source (None otherwise)."""

    segments: Tuple[Any, ...]
    shared_attn: Any = None
    cross_kv: Optional[torch.Tensor] = None


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cross_kv: Optional[torch.Tensor] = None, device=None) -> DecodeState:
    """Empty caches for ``batch`` sequences.  ``max_len`` is the positions
    of each attention cache; zamba2's shared cache spends
    :func:`shared_invocations` positions a token, so it holds ``max_len //
    shared_invocations(cfg)`` tokens.  An encoder-decoder decodes against
    ``cross_kv``, the encoder's output (:func:`encoder_forward`)."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    seg_caches = []
    for seg in segments_of(cfg):
        one = _init_layer_cache(seg.kind, cfg, batch, max_len, dt, device)
        seg_caches.append(type(one)(*(torch.stack([a] * seg.n) for a in one)))
    shared = (attn_mod.init_kv_cache(cfg, batch, max_len, dt, device)
              if _has_shared_attn(cfg) else None)
    return DecodeState(segments=tuple(seg_caches), shared_attn=shared, cross_kv=cross_kv)


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
    token; one host sync.  Recurrent caches have no positions to fill.  On
    ``meta`` (a dry run) nothing is checked: nothing is written."""
    if is_meta(state.segments[0][-1]):
        static_bound("models/lm.py:_cache_room", "no room check (a dry run writes nothing)")
        return
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
    """:func:`decode_step` on parameters already cast by :func:`cast_params`.
    An encoder-decoder's dense layers each attend to ``state.cross_kv``
    after their own block, the cross K / V projected anew every step, and
    its token gets no position, as the reference's decode does."""
    if cfg.is_encdec and state.cross_kv is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: build its decode state with "
                         "init_decode_state(..., cross_kv=encoder_forward(params, cfg, frames))")
    _cache_room(cfg, state)
    x = _embed_scaled(params, cfg, tokens)
    shared, shared_cache = params.get("shared_attn"), state.shared_attn
    whole = None
    if shared_cache is not None and shared_cache.length.shape[0] != tokens.shape[0]:
        # the shared cache's (B,) length is replicated over the data ranks in the
        # reference's layout (launch.partition.cache_shardings): a state cut from the
        # global one holds every row's, and this rank reads its own rows of it
        whole, (n, i) = shared_cache.length, sharding.split("batch")
        if whole.shape[0] != n * tokens.shape[0]:
            raise ValueError(f"the shared KV cache's length holds {whole.shape[0]} rows for "
                             f"{tokens.shape[0]} tokens on {n} data rank(s)")
        shared_cache = shared_cache._replace(
            length=whole.narrow(0, i * tokens.shape[0], tokens.shape[0]))
    cross = params.get("cross")
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
            if cross is not None and seg.kind in ("dense", "moe"):
                x = _cross_one(_layer(cross, seg.start + i), cfg, x, state.cross_kv)
        new_seg_caches.append(seg_cache._replace(length=seg_cache.length + 1))
    if whole is not None:
        shared_cache = shared_cache._replace(length=whole + shared_invocations(cfg))
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = logits_for(params, cfg, x)[:, 0]
    return logits, DecodeState(segments=tuple(new_seg_caches), shared_attn=shared_cache,
                               cross_kv=state.cross_kv)
