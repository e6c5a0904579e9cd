"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba runs attention heads and mamba heads in parallel within each layer and
fuses the branch outputs after per-branch normalization; most layers use
sliding-window attention, with full attention on the first/middle/last layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    window=1024,
    layer_pattern="hymba",
    activation="swiglu",
    rope_theta=10000.0,
    grad_accum=8,
    ssm_chunk=2048,
    source="arXiv:2411.13676",
)
