"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: 32L d4096 32H (GQA kv=32)
d_ff=13440 vocab=92416 — qwen1.5 arch (full MHA, SwiGLU, RoPE theta 1e6)."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    rope_theta=1e6,
    act="silu",
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab=256,
    rope_theta=1e6,
    act="silu",
    loss_chunk=16,
)
