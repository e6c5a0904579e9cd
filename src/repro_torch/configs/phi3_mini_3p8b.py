"""phi3-mini-3.8b — dense, RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32 == MHA) d_ff=8192 vocab=32064, head_dim=96.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    activation="swiglu",
    rope_theta=10000.0,
    grad_accum=8,
    source="arXiv:2404.14219",
)
