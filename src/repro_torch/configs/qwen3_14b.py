"""qwen3-14b — dense, qk_norm + GQA [hf:Qwen/Qwen3-8B family].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, head_dim=128,
per-head RMSNorm on q and k (qk_norm).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151_936,
    qk_norm=True,
    activation="swiglu",
    rope_theta=1_000_000.0,
    grad_accum=16,
    source="hf:Qwen/Qwen3-8B",
)
