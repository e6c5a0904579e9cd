"""pixtral-12b — VLM: pixtral-ViT frontend + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
Per the brief, the vision encoder is a STUB: ``input_specs`` provides
precomputed patch embeddings (B, n_patches, d_model) that the decoder
consumes as a sequence prefix ahead of the text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    frontend="vision",
    n_patches=1024,
    activation="swiglu",
    rope_theta=1_000_000.0,
    grad_accum=16,
    source="hf:mistralai/Pixtral-12B-2409",
)
