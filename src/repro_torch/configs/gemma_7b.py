"""Gemma-7B [arXiv:2403.08295]: 28L d3072 16H (kv=16) head_dim=256, GeGLU
d_ff=24576, vocab=256000, tied embeddings, embed scaling sqrt(d)."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,  # q/k/v heads are 256-wide (16*256 = 4096 != d_model)
    d_ff=24576,
    vocab=256000,
    rope_theta=1e4,
    act="gelu",  # GeGLU
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=192,
    vocab=512,
    act="gelu",
    tie_embeddings=True,
    loss_chunk=16,
)
