"""DeepSeek-V3-671B [arXiv:2412.19437]: 61L d7168 128H MLA, MoE 256 routed
(top-8) + 1 shared expert, expert d_ff=2048, first 3 layers dense
(d_ff=18432), vocab=129280.  MLA: q_lora 1536, kv_lora 512, nope 128,
rope 64, v 128.  (MTP head omitted — see DESIGN.md §Arch-applicability.)"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,  # nominal; MLA replaces classic KV heads
    d_ff=18432,  # the 3 dense layers
    vocab=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    d_ff_expert=2048,
    first_k_dense=3,
    router_aux_free_bias=True,
    rope_theta=1e4,
    act="silu",
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab=512,
    attn_type="mla",
    q_lora_rank=32,
    kv_lora_rank=16,
    rope_head_dim=8,
    nope_head_dim=16,
    v_head_dim=16,
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    d_ff_expert=48,
    first_k_dense=1,
    act="silu",
    loss_chunk=16,
)
