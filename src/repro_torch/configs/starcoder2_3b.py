"""starcoder2-3b — dense, GQA + RoPE [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152, head_dim=128,
non-gated GELU MLP, LayerNorm. StarCoder2 natively trains with a 4096-token
sliding window [arXiv:2402.19173 §4], which we use for the long-context
variant (long_500k).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    window=4096,           # native SWA; pattern 'global' = full attn by default
    activation="gelu",
    norm="layernorm",
    rope_theta=100_000.0,
    grad_accum=8,
    source="arXiv:2402.19173",
)
