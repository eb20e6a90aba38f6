"""GQA / MQA attention: prefill through the flash kernel, decode on a KV cache.

Port of the GQA half of ``repro/models/attention.py`` (MLA waits).  Causal
self-attention without a sliding window — every prefill and training
forward of the five ported configs, FULL and SMOKE — goes through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`, the
function the reference's Pallas kernel was written to replace: on a CUDA
tensor it launches the kernel (and raises at a head size it has no
instance for), on a CPU tensor it runs its plain version.
Cross-attention, non-causal attention and a sliding window go through
:func:`_attend_chunked`, the reference's online softmax over KV chunks in
plain torch, which is also what decode uses: one query against a cache
with a valid-length mask.  Both routes are static, never by a failure.

The kernel has no backward, as the reference's Pallas kernel has none (the
reference trains through ``_attend_chunked``).  When any of q, k or v
requires grad, :func:`gqa_forward` calls :class:`FlashAttentionFn`, whose
forward is the kernel and whose backward recomputes ``_attend_chunked`` one
query tile at a time and returns its vector-Jacobian product; otherwise it
calls the kernel bare.  The route is static (by ``requires_grad``), never
taken on a failure.  So:

* the gradient is the plain function's, the reference's gradient;
* ``_attend_chunked`` rounds ``q * scale`` to the compute dtype before the
  upcast, as the reference does, and the kernel upcasts q first: in
  float32 the two agree to rounding, in bf16 the gradient is that of a
  function that differs from the forward by the bf16 rounding of q * scale;
* under layer remat (``cfg.remat``) the forward kernel launches twice a
  layer a training step: once in the forward, once in the recompute.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig
from .layers import apply_rope, dense_init

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
    """Causal self-attention with the flash kernel forward and the plain
    function's gradient: the backward recomputes :func:`_attend_chunked`
    (``chunk`` keys a block) on detached copies, one query tile of ``chunk``
    rows at a time (``q_offset`` placing it), so that at most one tile's
    scores are alive, and returns its vector-Jacobian product; dk and dv are
    summed over the tiles in float32."""

    @staticmethod
    def forward(ctx, q, k, v, chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.chunk = chunk
        return flash_attention(q, k, v, causal=True)

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
                out = _attend_chunked(qt, k, v, causal=True, q_offset=q0, chunk=chunk)
            gq, gk, gv = torch.autograd.grad(out, (qt, k, v), grad_out[:, q0:q0 + tile])
            dq[:, q0:q0 + tile] = gq
            dk += gk
            dv += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None


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
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def gqa_forward(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    rope: bool = True,
    kv: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,  # cross-attention source
) -> torch.Tensor:
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, hd)
    if kv is None:
        k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        src = kv[0]
        sk = src.shape[1]
        k = (src @ params["wk"]).reshape(b, sk, cfg.n_kv_heads, hd)
        v = (src @ params["wv"]).reshape(b, sk, cfg.n_kv_heads, hd)
    if causal and kv is None and not cfg.sliding_window:
        if q.requires_grad or k.requires_grad or v.requires_grad:
            out = FlashAttentionFn.apply(q, k, v, cfg.attn_chunk)
        else:
            out = flash_attention(q, k, v, causal=True)
    else:
        out = _attend_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                              sliding_window=cfg.sliding_window)
    return out.reshape(b, s, cfg.n_heads * hd) @ params["wo"]


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
    and token), so the returned cache shares its tensors with the old one."""
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"gqa_decode takes one position per sequence; got {s}")
    hd = cfg.resolved_head_dim
    pos = cache.length[:, None]  # (B, 1)
    q = (x @ params["wq"]).reshape(b, 1, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
    if rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    idx = cache.length.long()
    cache.k[rows, idx] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, idx] = v[:, 0].to(cache.v.dtype)
    out = _attend_chunked(
        q, cache.k, cache.v,
        causal=False,  # masking via kv_valid_len
        chunk=cfg.attn_chunk,
        kv_valid_len=cache.length + 1,
        sliding_window=cfg.sliding_window,
    )
    y = out.reshape(b, 1, cfg.n_heads * hd) @ params["wo"]
    return y, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
