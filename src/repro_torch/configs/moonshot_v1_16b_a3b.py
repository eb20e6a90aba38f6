"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 48L d2048 16H
(kv=16), MoE 64 routed top-6 + 2 shared, expert d_ff=1408, first layer
dense (d_ff=11264), vocab=163840 — deepseek-v3-style arch at 16B scale."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,  # first dense layer
    vocab=163840,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    first_k_dense=1,
    router_aux_free_bias=True,
    rope_theta=5e4,
    act="silu",
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab=512,
    n_experts=8,
    top_k=2,
    n_shared_experts=2,
    d_ff_expert=48,
    first_k_dense=1,
    act="silu",
    loss_chunk=16,
)
