"""Plain PyTorch version of the flash attention kernel (held against it).

Naive float32 softmax attention in the kernel's ``(B, S, H, D)`` GQA layout:
query head h reads KV head ``h // (H // KH)``, the reference's
``jnp.repeat`` mapping.  q, k and v are converted to float32 before q is
scaled by ``D**-0.5``, as the TPU kernel does; masked scores are filled
with ``-1e30``; the output is cast to q's dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) -> (B, Sq, H, D).

    ``causal`` keeps kv_pos <= q_pos (the mask aligned top-left, the TPU
    kernel's), which the wrapper only ever asks for with Sq == Sk."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qf = (q.float() * d**-0.5).reshape(b, sq, kh, h // kh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
