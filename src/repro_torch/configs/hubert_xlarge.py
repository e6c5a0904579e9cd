"""hubert-xlarge — encoder-only audio transformer (w2v2 arch) [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit targets).
Per the brief the conv feature extractor is a STUB: ``input_specs`` provides
precomputed frame embeddings (B, T, 1280); we implement the transformer
encoder (bidirectional, no decode shapes).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    frontend="audio",
    activation="gelu",
    norm="layernorm",
    grad_accum=8,
    source="arXiv:2106.07447",
)
