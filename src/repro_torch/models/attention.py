"""Attention: GQA / MQA (prefill through the flash kernel, decode on a KV
cache) and MLA (DeepSeek-V3's latent attention, plain torch).

Port of ``repro/models/attention.py``.  Every GQA attention without a
sliding window goes through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`, the
function the reference's Pallas kernel was written to replace: causal
self-attention (every decoder's prefill and training forward, zamba2's
shared block among them), non-causal self-attention (Whisper's encoder)
and cross-attention (``kv=``: Whisper's decoder against the encoder's
output, Sk from the source, in the prefill and at Sq = 1 in decode).  On a
CUDA tensor it launches the kernel (and raises at a head size it has no
instance for), on a CPU tensor it runs its plain version.  A sliding
window goes through :func:`_attend_chunked`, the reference's online
softmax over KV chunks in plain torch, which is also what the decode cache
uses: one query against a cache with a valid-length mask, which the kernel
has no input for.  The routes are static, never taken on a failure.

The kernel has no backward, as the reference's Pallas kernel has none (the
reference trains through ``_attend_chunked``).  When any of q, k or v
requires grad, :func:`gqa_forward` calls :class:`FlashAttentionFn`, whose
forward is the kernel and whose backward recomputes ``_attend_chunked``
with the same ``causal`` one query tile at a time and returns its
vector-Jacobian product; otherwise it calls the kernel bare.  The route is
static (by ``requires_grad``), never taken on a failure.  So:

* the gradient is the plain function's, the reference's gradient;
* ``_attend_chunked`` rounds ``q * scale`` to the compute dtype before the
  upcast, as the reference does, and the kernel upcasts q first: in
  float32 the two agree to rounding, in bf16 the gradient is that of a
  function that differs from the forward by the bf16 rounding of q * scale;
* under layer remat (``cfg.remat``) the forward kernel launches twice a
  layer a training step: once in the forward, once in the recompute.

Under active sharding rules (:mod:`repro_torch.dist.sharding`)
:func:`gqa_forward` runs this rank's heads: its blocks of ``wq`` / ``wo``
(column- and row-parallel) and of ``wk`` / ``wv`` when ``kv_heads`` is
split too, the output's partial sum reduced over the model axis.  When the
rules split the query heads and replicate the kv heads (granite-34b's one
kv head at any TP, minitron-4b's 8 at TP 3), a rank whose heads straddle
two groups hands the kernel the kv head of each of its query heads (G = 1).
:func:`gqa_decode` runs the same heads against a cache of the rank's kv
heads (:func:`init_kv_cache` under the rules; all of them where
``kv_heads`` is replicated, each query head then reading its own at G = 1
as in the prefill), ``wo`` row-parallel and reduced.

MLA has no kernel in the reference either: its prefill is the plain
``_attend_chunked`` with a q / k head of ``nope + rope`` and a v head of
``v_head_dim`` (192 and 128 at deepseek-v3's width), which the flash
kernels, whose q, k and v share one D, do not take.  Its decode cache holds
the latent ``c_kv`` and the shared RoPE key alone, written in place as the
GQA cache is; :func:`mla_decode` expands it to per-head K / V every step,
:func:`mla_decode_absorbed` folds ``w_uk`` into the query and ``w_uv`` into
the output and attends in the latent space in float32 (``cfg.mla_absorbed``
picks one in ``lm``).  Under rules that shard ``heads``, each runs this
rank's heads (its blocks of ``w_uq`` or ``w_q``, ``w_uk``, ``w_uv`` and
the row-parallel ``wo``, reduced over the model axis) against the latent
path, which is replicated: ``w_dq``, ``q_norm``, ``w_dkv``, ``kv_norm`` and
``w_krope`` compute the same ``cq``, ``c_kv`` and ``k_rope`` on every model
rank (a decode cache holds the whole latent of the rank's rows), and the
three sum their cotangents over the model axis where they enter the
head-parallel products.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..dist import sharding
from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig
from .layers import apply_rope, dense_init, init_norm, rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked online-softmax attention (plain torch)
# ---------------------------------------------------------------------------


def _attend_chunked(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, K, Dh)
    v: torch.Tensor,  # (B, Sk, K, Dv)
    *,
    causal: bool,
    q_offset: int = 0,
    chunk: int = 1024,
    scale: Optional[float] = None,
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,) valid cache length (decode)
    sliding_window: int = 0,
) -> torch.Tensor:
    """Online softmax over KV chunks of ``chunk`` keys, query tiles of up to
    ``chunk`` rows, masked scores filled with -1e30: the reference's
    algorithm (its ``lax.scan`` loops become Python loops, and the ragged
    last chunk is sliced rather than zero-padded and masked).  GQA: H = G K.
    """
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kh
    scale = scale if scale is not None else dh**-0.5
    qf = (q * scale).float().reshape(b, sq, kh, g, dh)
    q_chunk = chunk if sq >= chunk else sq
    outs = []
    for q0 in range(0, sq, q_chunk):
        q_tile = qf[:, q0:q0 + q_chunk]
        tq = q_tile.shape[1]
        q_pos = q_offset + q0 + torch.arange(tq, device=q.device)
        m = torch.full((b, kh, g, tq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kh, g, tq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, tq, dv), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, chunk):
            kb = k[:, k0:k0 + chunk].float()
            vb = v[:, k0:k0 + chunk].float()
            kv_pos = k0 + torch.arange(kb.shape[1], device=q.device)
            s = torch.einsum("bqkgd,bckd->bkgqc", q_tile, kb)
            mask = torch.ones((tq, kb.shape[1]), dtype=torch.bool, device=q.device)
            if causal:
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            if sliding_window:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - sliding_window)
            if kv_valid_len is not None:
                vmask = kv_pos[None, :] < kv_valid_len[:, None]  # (B, Ck)
                s = s.masked_fill(~vmask[:, None, None, None, :], NEG_INF)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, vb)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, Tq, K, G, Dv)
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv).to(q.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the flash kernel forward and the plain function's
    gradient: ``apply(q, k, v, chunk, causal=True)``, q (B, Sq, H, D)
    against k, v (B, Sk, KH, D) (``causal`` needs Sq == Sk).  The backward
    recomputes :func:`_attend_chunked` with the same ``causal`` (``chunk``
    keys a block) on detached copies, one query tile of ``chunk`` rows at a
    time (``q_offset`` placing it), so that at most one tile's scores are
    alive, and returns its vector-Jacobian product; dk and dv are summed
    over the tiles in float32."""

    @staticmethod
    def forward(ctx, q, k, v, chunk: int, causal: bool = True):
        ctx.save_for_backward(q, k, v)
        ctx.chunk, ctx.causal = chunk, causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        k, v = (t.detach().requires_grad_(True) for t in (k, v))
        sq, chunk = q.shape[1], ctx.chunk
        tile = chunk if sq >= chunk else sq  # _attend_chunked's query tile
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for q0 in range(0, sq, tile):
            qt = q[:, q0:q0 + tile].detach().requires_grad_(True)
            with torch.enable_grad():
                out = _attend_chunked(qt, k, v, causal=ctx.causal, q_offset=q0, chunk=chunk)
            gq, gk, gv = torch.autograd.grad(out, (qt, k, v), grad_out[:, q0:q0 + tile])
            dq[:, q0:q0 + tile] = gq
            dk += gk
            dv += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


# ---------------------------------------------------------------------------
# GQA / MQA
# ---------------------------------------------------------------------------


def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype),
    }


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, K, Dh)
    v: torch.Tensor  # (B, S_max, K, Dv)
    length: torch.Tensor  # (B,) int32 — filled positions


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device=None) -> KVCache:
    """An empty cache of ``batch`` rows; under active rules that split
    ``kv_heads``, of this rank's kv heads."""
    hd = cfg.resolved_head_dim
    kh, _ = sharding.local_block(cfg.n_kv_heads, "kv_heads", "the KV cache")
    shape = (batch, max_len, kh, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _local_heads(params: dict, cfg: ModelConfig) -> Tuple[int, int, Optional[torch.Tensor]]:
    """(query heads, kv heads) of this rank's blocks of ``wq`` / ``wk``
    under the active rules, and the kv head each local query head reads
    when the rank's heads need a gather (else ``None``).

    Heads sharded over the model axis with the kv heads replicated (MQA,
    or KH not divisible by the ranks: granite-34b at any TP, minitron-4b at
    TP 3) give a rank query heads whose groups the uniform G = H / KH of
    the flash kernels does not describe when KH > 1 (a rank's heads can
    straddle two groups): the rank then takes, for each of its query heads,
    the kv head of its group, G = 1."""
    hd = cfg.resolved_head_dim
    h, h0 = sharding.local_block(cfg.n_heads, "heads", "attn/wq")
    kh, _ = sharding.local_block(cfg.n_kv_heads, "kv_heads", "attn/wk")
    if params["wq"].shape[-1] != h * hd or params["wk"].shape[-1] != kh * hd:
        raise ValueError(f"{cfg.name}: attention blocks of width {params['wq'].shape[-1]} / "
                         f"{params['wk'].shape[-1]}, but the active rules give this rank "
                         f"{h} / {kh} heads of {hd}")
    if h == cfg.n_heads or kh != cfg.n_kv_heads or kh == 1:
        return h, kh, None
    g = cfg.n_heads // cfg.n_kv_heads
    return h, kh, torch.div(h0 + torch.arange(h), g, rounding_mode="floor")


def gqa_forward(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: Optional[torch.Tensor],  # (B, S); read only with rope and no kv
    *,
    causal: bool = True,
    rope: bool = True,
    kv: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,  # cross-attention source
) -> torch.Tensor:
    """Attention over this rank's heads: all of them without rules; under
    rules that shard ``heads``, the rank's block of ``wq`` / ``wo`` (and of
    ``wk`` / ``wv`` when ``kv_heads`` is sharded too; replicated, their
    gradients are summed over the model axis), the output's partial sum
    reduced over the model axis."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    h, kh, kv_of = _local_heads(params, cfg)
    tp = h != cfg.n_heads
    wk, wv = params["wk"], params["wv"]
    if tp:
        x = sharding.grad_reduce_boundary(x)
        if kh == cfg.n_kv_heads:  # replicated inside the block: partial gradients
            wk, wv = sharding.grad_reduce_boundary(wk), sharding.grad_reduce_boundary(wv)
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    if kv is None:
        k = (x @ wk).reshape(b, s, kh, hd)
        v = (x @ wv).reshape(b, s, kh, hd)
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        src = sharding.grad_reduce_boundary(kv[0]) if tp else kv[0]
        sk = src.shape[1]
        k = (src @ wk).reshape(b, sk, kh, hd)
        v = (src @ wv).reshape(b, sk, kh, hd)
    if kv_of is not None:  # G = 1: each local query head's own kv head
        kv_of = kv_of.to(k.device)
        k, v = k.index_select(2, kv_of), v.index_select(2, kv_of)
    if cfg.sliding_window:
        out = _attend_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                              sliding_window=cfg.sliding_window)
    elif q.requires_grad or k.requires_grad or v.requires_grad:
        out = FlashAttentionFn.apply(q, k, v, cfg.attn_chunk, causal)
    else:
        out = flash_attention(q, k, v, causal=causal)
    y = out.reshape(b, s, h * hd) @ params["wo"]
    return sharding.constrain(y) if tp else y


def gqa_decode(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache: KVCache,
    *,
    rope: bool = True,
) -> Tuple[torch.Tensor, KVCache]:
    """One position per sequence against the cache.  The new key and value
    are written into ``cache.k`` / ``cache.v`` in place (the reference
    returns updated copies; in place saves a copy of the cache per layer
    and token), so the returned cache shares its tensors with the old one.
    Under rules that shard ``heads``: this rank's heads (as
    :func:`gqa_forward`'s), its kv heads' cache, the output reduced over the
    model axis."""
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"gqa_decode takes one position per sequence; got {s}")
    hd = cfg.resolved_head_dim
    h, kh, kv_of = _local_heads(params, cfg)
    if cache.k.shape[2] != kh:
        raise ValueError(f"{cfg.name}: a KV cache of {cache.k.shape[2]} kv heads, but the "
                         f"active rules give this rank {kh}")
    pos = cache.length[:, None]  # (B, 1)
    q = (x @ params["wq"]).reshape(b, 1, h, hd)
    k = (x @ params["wk"]).reshape(b, 1, kh, hd)
    v = (x @ params["wv"]).reshape(b, 1, kh, hd)
    if rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    idx = cache.length.long()
    cache.k[rows, idx] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, idx] = v[:, 0].to(cache.v.dtype)
    ck, cv = cache.k, cache.v
    if kv_of is not None:  # G = 1: each local query head's own kv head
        kv_of = kv_of.to(ck.device)
        ck, cv = ck.index_select(2, kv_of), cv.index_select(2, kv_of)
    out = _attend_chunked(
        q, ck, cv,
        causal=False,  # masking via kv_valid_len
        chunk=cfg.attn_chunk,
        kv_valid_len=cache.length + 1,
        sliding_window=cfg.sliding_window,
    )
    y = out.reshape(b, 1, h * hd) @ params["wo"]
    if h != cfg.n_heads:
        y = sharding.constrain(y)
    return y, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    h = cfg.n_heads
    p = {
        "w_dkv": dense_init(gen, d, cfg.kv_lora_rank, dtype),  # latent down
        "w_krope": dense_init(gen, d, dr, dtype),  # shared rope key
        "kv_norm": init_norm(cfg.kv_lora_rank, dtype, gen.device),
        "w_uk": dense_init(gen, cfg.kv_lora_rank, h * dn, dtype),
        "w_uv": dense_init(gen, cfg.kv_lora_rank, h * dv, dtype),
        "wo": dense_init(gen, h * dv, d, dtype),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, cfg.q_lora_rank, dtype)
        p["q_norm"] = init_norm(cfg.q_lora_rank, dtype, gen.device)
        p["w_uq"] = dense_init(gen, cfg.q_lora_rank, h * (dn + dr), dtype)
    else:
        p["w_q"] = dense_init(gen, d, h * (dn + dr), dtype)
    return p


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, S_max, kv_lora_rank) — the compressed latent
    k_rope: torch.Tensor  # (B, S_max, rope_head_dim)
    length: torch.Tensor  # (B,) int32 — filled positions


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _mla_local_heads(params: dict, cfg: ModelConfig) -> int:
    """This rank's MLA heads under the active rules (all of them without
    rules, or where ``heads`` does not split), checked against the widths of
    its blocks of ``w_uq`` (or ``w_q``), ``w_uk``, ``w_uv`` and ``wo``."""
    h, _ = sharding.local_block(cfg.n_heads, "heads", "attn/w_uk")
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    wq = params["w_uq"] if cfg.q_lora_rank else params["w_q"]
    got = (wq.shape[-1], params["w_uk"].shape[-1], params["w_uv"].shape[-1],
           params["wo"].shape[-2])
    if got != (h * (dn + dr), h * dn, h * dv, h * dv):
        raise ValueError(f"{cfg.name}: MLA blocks of widths {got} (w_q / w_uq, w_uk, w_uv, wo), "
                         f"but the active rules give this rank {h} heads of {dn} + {dr} / {dv}")
    return h


def _mla_q(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
           h: int, tp: bool = False) -> torch.Tensor:
    """-> q (B, S, h, nope + rope) of this rank's ``h`` heads, the rope half
    rotated.  Under tensor parallelism (``tp``) the replicated activation
    entering the head-parallel product (``cq``, or ``x`` without a q latent)
    sums its cotangent over the model axis."""
    b, s, _ = x.shape
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
        q = (sharding.grad_reduce_boundary(cq) if tp else cq) @ params["w_uq"]
    else:
        q = (sharding.grad_reduce_boundary(x) if tp else x) @ params["w_q"]
    q = q.reshape(b, s, h, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    return torch.cat([q[..., :dn], q_rope], dim=-1)


def _mla_latent(params: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (c_kv (B, S, kv_lora_rank) normed, k_rope (B, S, rope) rotated):
    what the decode cache keeps of x, whole on every model rank."""
    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"], cfg.norm_eps)
    k_rope = apply_rope((x @ params["w_krope"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_kv_from_latent(params: dict, cfg: ModelConfig, c_kv: torch.Tensor,
                        k_rope: torch.Tensor, h: int,
                        tp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand the latent to per-head K (nope || rope) and V of this rank's
    ``h`` heads; under ``tp`` the replicated latent and rope key sum their
    cotangents over the model axis."""
    b, sk, _ = c_kv.shape
    dn, dv = cfg.nope_head_dim, cfg.v_head_dim
    if tp:
        c_kv, k_rope = sharding.grad_reduce_boundary(c_kv), sharding.grad_reduce_boundary(k_rope)
    k_nope = (c_kv @ params["w_uk"]).reshape(b, sk, h, dn)
    v = (c_kv @ params["w_uv"]).reshape(b, sk, h, dv)
    k_rope_b = k_rope[:, :, None, :].expand(b, sk, h, cfg.rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def mla_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Causal MLA over (B, S, D): the plain ``_attend_chunked`` with q / k
    heads of nope + rope and v heads of ``v_head_dim``, on this rank's heads
    (``wo`` row-parallel, its partial sum reduced over the model axis)."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    h = _mla_local_heads(params, cfg)
    tp = h != cfg.n_heads
    q = _mla_q(params, cfg, x, positions, h, tp)
    k, v = _mla_kv_from_latent(params, cfg, *_mla_latent(params, cfg, x, positions), h, tp)
    out = _attend_chunked(q, k, v, causal=True, chunk=cfg.attn_chunk, scale=(dn + dr) ** -0.5)
    y = out.reshape(b, s, h * dv) @ params["wo"]
    return sharding.constrain(y) if tp else y


def _mla_append(params: dict, cfg: ModelConfig, x: torch.Tensor, cache: MLACache,
                h: int) -> torch.Tensor:
    """Write x's latent and rope key at each row's ``cache.length``, in
    place (every model rank writes the same latent); -> the query (B, 1, h,
    nope + rope) of this rank's ``h`` heads at that position."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"MLA decode takes one position per sequence; got {s}")
    pos = cache.length[:, None]  # (B, 1)
    c_new, kr_new = _mla_latent(params, cfg, x, pos)
    rows, idx = torch.arange(b, device=x.device), cache.length.long()
    cache.c_kv[rows, idx] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[rows, idx] = kr_new[:, 0].to(cache.k_rope.dtype)
    return _mla_q(params, cfg, x, pos, h)


def mla_decode_absorbed(params: dict, cfg: ModelConfig, x: torch.Tensor,
                        cache: MLACache) -> Tuple[torch.Tensor, MLACache]:
    """One position against the latent cache with DeepSeek's weight
    absorption, in float32 as the reference: scores = (q_nope W_uk) . c_kv +
    q_rope . k_rope, out = softmax(scores) . c_kv, y = out W_uv W_o.  No
    (S, H) key or value is built.  The cache is written in place.  Under
    rules that shard ``heads``: this rank's heads against the whole latent,
    the output reduced over the model axis."""
    b = x.shape[0]
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    h = _mla_local_heads(params, cfg)
    q = _mla_append(params, cfg, x, cache, h)
    q_nope, q_rope = q[:, 0, :, :dn].float(), q[:, 0, :, dn:].float()
    c_kv = cache.c_kv.float()
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, params["w_uk"].reshape(r, h, dn).float())
    scores = (torch.einsum("bhr,bsr->bhs", q_lat, c_kv)
              + torch.einsum("bhr,bsr->bhs", q_rope, cache.k_rope.float())) * (dn + dr) ** -0.5
    valid = torch.arange(c_kv.shape[1], device=x.device)[None, None, :] \
        < (cache.length + 1)[:, None, None]
    w = torch.softmax(scores.masked_fill(~valid, NEG_INF), dim=-1)
    out_lat = torch.einsum("bhs,bsr->bhr", w, c_kv)  # (B, h, R)
    out_v = torch.einsum("bhr,rhv->bhv", out_lat, params["w_uv"].reshape(r, h, dv).float())
    y = out_v.reshape(b, 1, h * dv).to(x.dtype) @ params["wo"]
    if h != cfg.n_heads:
        y = sharding.constrain(y)
    return y, MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope, length=cache.length + 1)


def mla_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: MLACache) -> Tuple[torch.Tensor, MLACache]:
    """One position against the latent cache, expanded to per-head K / V
    over the whole cache (``_attend_chunked`` with a valid-length mask).
    The cache is written in place.  Under rules that shard ``heads``: this
    rank's heads, the output reduced over the model axis."""
    b = x.shape[0]
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    h = _mla_local_heads(params, cfg)
    q = _mla_append(params, cfg, x, cache, h)
    k, v = _mla_kv_from_latent(params, cfg, cache.c_kv, cache.k_rope, h)
    out = _attend_chunked(q, k, v, causal=False, chunk=cfg.attn_chunk,
                          scale=(dn + dr) ** -0.5, kv_valid_len=cache.length + 1)
    y = out.reshape(b, 1, h * dv) @ params["wo"]
    if h != cfg.n_heads:
        y = sharding.constrain(y)
    return y, MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope, length=cache.length + 1)
