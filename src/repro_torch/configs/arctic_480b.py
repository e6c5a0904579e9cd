"""arctic-480b — dense-MoE hybrid: 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (per-expert) vocab=32000,
head_dim=128. Arctic composes a small dense residual MLP in parallel with
the top-2-of-128 MoE FFN.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dense_d_ff=4864,
    activation="swiglu",
    rope_theta=10000.0,
    fsdp=True,
    grad_accum=16,
    source="hf:Snowflake/snowflake-arctic-base",
)
