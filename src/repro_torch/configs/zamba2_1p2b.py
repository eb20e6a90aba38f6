"""Zamba2-1.2B [arXiv:2411.15242]: 38 Mamba2 layers d2048 (ssm_state=64)
with a single *shared* attention+MLP block (32H, kv=32, d_ff=8192) invoked
every 6th layer, vocab=32000.  (Zamba2's per-invocation LoRA deltas on the
shared block are omitted — simplification noted in DESIGN.md.)"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,  # shared block MLP
    vocab=32000,
    block_type="mamba2",
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_groups=8,
    attn_every=6,
    rope_theta=1e4,
    act="silu",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    block_type="mamba2",
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=16,
    ssm_groups=2,
    attn_every=2,
    act="silu",
    loss_chunk=16,
)
