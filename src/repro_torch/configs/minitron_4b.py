"""Minitron-4B [arXiv:2407.14679]: pruned Nemotron — 32L d3072 24H (GQA kv=8)
d_ff=9216 vocab=256000.  Note 24 heads / 8 kv-heads do not divide the 16-wide
model axis; the reference's TP falls back to mlp+vocab only for this arch
(``repro/dist/sharding.py``)."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    mlp_variant="plain",
    rope_theta=1e4,
    act="silu",  # nemotron uses squared-relu; silu kept for GLU-family uniformity
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    mlp_variant="plain",
    act="silu",
    loss_chunk=16,
)
