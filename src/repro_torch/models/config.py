"""Unified model configuration: a copy of ``repro/models/config.py``.

One superset dataclass covering all ten architectures of the reference's
registry, and the analytic ``count_params``.  Kept whole (it is data and
arithmetic) so that a port config and a reference config with the same
fields describe the same model; the port runs the decoder-only GQA
transformers of it, dense and MoE (``repro_torch.configs.registry``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention ---------------------------------------------------------
    attn_type: str = "gqa"  # gqa | mla
    rope_theta: float = 1e4
    use_rope: bool = True  # False => absolute sinusoidal positions (whisper)
    attn_chunk: int = 1024  # online-softmax KV chunk (flash-style)
    sliding_window: int = 0  # 0 = full attention

    # --- MLA (deepseek-v3) --------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    mla_absorbed: bool = False  # decode via weight absorption (EXPERIMENTS §Perf)

    # --- MLP ----------------------------------------------------------------
    act: str = "silu"  # silu (swiglu) | gelu (geglu)
    mlp_variant: str = "glu"  # glu (3 mats) | plain (2 mats: granite/minitron/whisper)

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_free_bias: bool = True  # deepseek aux-loss-free balancing

    # --- SSM (mamba2) / hybrid ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_groups: int = 8
    attn_every: int = 0  # hybrid: shared attention block every k-th layer

    # --- xLSTM ---------------------------------------------------------------
    slstm_every: int = 0  # every k-th block is sLSTM (rest mLSTM); 0 = none

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 1500  # encoder positions (frames after conv stub)

    # --- VLM (pixtral) --------------------------------------------------------
    n_img_tokens: int = 0  # patch embeddings prepended to the text stream

    # --- block selection -------------------------------------------------------
    block_type: str = "transformer"  # transformer | mamba2 | xlstm

    # --- norms / embeddings ----------------------------------------------------
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0  # gemma-style final softcap (0 = off)

    # --- numerics / compilation --------------------------------------------------
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    loss_chunk: int = 512  # sequence chunking for the LM head (memory)

    # -------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded so TP-16 sharding divides evenly (Megatron-style)."""
        return _round_up(self.vocab, 256)

    @property
    def d_ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_ssm_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, resolving hybrid / first-k-dense patterns."""
        kinds = []
        for i in range(self.n_layers):
            if self.block_type == "mamba2":
                kinds.append("mamba2")
            elif self.block_type == "xlstm":
                if self.slstm_every and (i % self.slstm_every == self.slstm_every - 1):
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.is_moe and i >= self.first_k_dense:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    def validate(self) -> "ModelConfig":
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.attn_type == "mla"
        if self.is_moe:
            assert self.top_k > 0 and self.d_ff_expert > 0
        if self.block_type == "mamba2":
            assert self.ssm_state > 0
            assert self.d_ssm_inner % self.ssm_head_dim == 0
        if self.attn_type == "mla":
            assert self.kv_lora_rank > 0 and self.nope_head_dim > 0
        return self


# Parameter counting (for roofline MODEL_FLOPS = 6 N D, DESIGN.md §Roofline) --


def count_params(cfg: ModelConfig) -> dict:
    """Analytical parameter counts: total and active-per-token (MoE)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    v = cfg.vocab_padded
    embed = v * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        if cfg.attn_type == "mla":
            q = (
                d * cfg.q_lora_rank
                + cfg.q_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
                if cfg.q_lora_rank
                else d * cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
            )
            kv = d * (cfg.kv_lora_rank + cfg.rope_head_dim) + cfg.kv_lora_rank * cfg.n_heads * (
                cfg.nope_head_dim + cfg.v_head_dim
            )
            o = cfg.n_heads * cfg.v_head_dim * d
            return q + kv + o
        q = d * cfg.n_heads * hd
        kv = 2 * d * cfg.n_kv_heads * hd
        o = cfg.n_heads * hd * d
        return q + kv + o

    def dense_mlp():
        mats = 3 if cfg.mlp_variant == "glu" else 2
        return mats * d * cfg.d_ff

    def moe_mlp():
        per_expert = 3 * d * cfg.d_ff_expert
        shared = cfg.n_shared_experts * per_expert
        router = d * cfg.n_experts
        return cfg.n_experts * per_expert + shared + router

    def mamba2_block():
        din, ns, g = cfg.d_ssm_inner, cfg.ssm_state, cfg.ssm_groups
        nh = cfg.n_ssm_heads
        in_proj = d * (2 * din + 2 * g * ns + nh)
        conv = cfg.ssm_conv * (din + 2 * g * ns)
        out = din * d
        return in_proj + conv + out + 3 * nh  # + A, D, dt_bias

    def mlstm_block():
        din = 2 * d
        return d * (3 * din) + din * d + 3 * (d * din // 4)  # qkv-ish + gates + out

    def slstm_block():
        return 4 * d * d * 2 + int(2.7 * d * d)

    total = embed
    active = embed
    for kind in cfg.layer_kinds():
        if kind == "dense":
            p = attn_params() + dense_mlp()
            total += p
            active += p
        elif kind == "moe":
            pe = 3 * d * cfg.d_ff_expert
            shared = cfg.n_shared_experts * pe
            total += attn_params() + moe_mlp()
            active += attn_params() + shared + cfg.top_k * pe + d * cfg.n_experts
        elif kind == "mamba2":
            p = mamba2_block()
            if cfg.attn_every:
                pass  # shared attn counted once below
            total += p
            active += p
        elif kind == "mlstm":
            p = mlstm_block()
            total += p
            active += p
        elif kind == "slstm":
            p = slstm_block()
            total += p
            active += p
    if cfg.attn_every and cfg.block_type == "mamba2":
        p = attn_params() + dense_mlp()
        total += p  # one shared block
        active += p
    if cfg.is_encdec:
        enc = cfg.n_enc_layers * (attn_params() + dense_mlp())
        dec_cross = cfg.n_layers * attn_params()
        total += enc + dec_cross
        active += enc + dec_cross
    return {"total": int(total), "active": int(active)}
