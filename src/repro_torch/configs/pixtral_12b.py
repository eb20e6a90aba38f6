"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: 40L d5120 32H (GQA kv=8)
d_ff=14336 vocab=131072 — mistral-nemo backbone; the pixtral ViT frontend is
a STUB per the assignment (input_specs provides precomputed patch embeddings
that are prepended to the text stream)."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    n_img_tokens=1024,  # 1024 patch embeddings per example (stub frontend)
    rope_theta=1e6,
    act="silu",
)

SMOKE = ModelConfig(
    name="pixtral-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab=256,
    n_img_tokens=8,
    act="silu",
    loss_chunk=16,
)
