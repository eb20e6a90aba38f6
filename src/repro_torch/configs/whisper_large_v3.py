"""Whisper-large-v3 [arXiv:2212.04356]: enc-dec, 32+32L d1280 20H (kv=20)
d_ff=5120 vocab=51866.  The conv1d mel frontend is a STUB per the
assignment: input_specs provides post-conv frame embeddings (B, S, d)
directly; sinusoidal encoder positions; no RoPE (learned/sinusoidal-style
absolute positions).  Note 20 heads do not divide the 16-wide model axis;
the reference's TP falls back to mlp+vocab for this arch
(``repro/dist/sharding.py``)."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,  # decoder
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    mlp_variant="plain",
    is_encdec=True,
    n_enc_layers=32,
    norm_type="layernorm",
    act="gelu",
    use_rope=False,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    mlp_variant="plain",
    is_encdec=True,
    n_enc_layers=2,
    norm_type="layernorm",
    act="gelu",
    use_rope=False,
    loss_chunk=16,
)
