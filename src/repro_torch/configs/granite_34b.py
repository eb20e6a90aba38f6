"""Granite-34B-Code [arXiv:2405.04324]: 88L d6144 48H MQA (kv=1)
d_ff=24576 vocab=49152 — llama-arch code model with multi-query attention."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,  # MQA
    d_ff=24576,
    vocab=49152,
    mlp_variant="plain",
    rope_theta=1e4,
    act="silu",
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=1,
    d_ff=256,
    vocab=384,
    mlp_variant="plain",
    act="silu",
    loss_chunk=16,
)
