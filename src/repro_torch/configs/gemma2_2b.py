"""gemma2-2b — dense, local+global alternating attention, logit softcap
[arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256,
4096-token sliding window on local (even) layers, attention softcap 50,
final-logit softcap 30, GeGLU MLP, pre+post RMSNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    window=4096,
    layer_pattern="local_global",
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    grad_accum=8,
    source="arXiv:2408.00118",
)
