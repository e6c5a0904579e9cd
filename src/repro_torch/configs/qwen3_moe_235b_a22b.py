"""qwen3-moe-235b-a22b — MoE, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per-expert) vocab=151936,
head_dim=128, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151_936,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    activation="swiglu",
    rope_theta=1_000_000.0,
    fsdp=True,
    grad_accum=16,
    source="hf:Qwen/Qwen3-30B-A3B",
)
