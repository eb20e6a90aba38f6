"""xLSTM-350M [arXiv:2405.04517]: 24 blocks d1024 4H vocab=50304, mLSTM
blocks with an sLSTM block every 8th (the paper's x:1 interleave), no
separate FFN (d_ff=0 — projections live inside the xLSTM blocks)."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_type="xlstm",
    slstm_every=8,
    act="gelu",
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    block_type="xlstm",
    slstm_every=2,
    act="gelu",
    loss_chunk=16,
)
