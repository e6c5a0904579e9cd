"""falcon-mamba-7b — attention-free mamba1 SSM [arXiv:2410.05355].

64L d_model=4096 (no attention) vocab=65024, ssm_state=16, expand=2
(d_inner=8192), conv kernel 4, dt_rank=d_model/16=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    dt_rank=256,
    tie_embeddings=True,
    grad_accum=16,
    ssm_chunk=1024,
    source="arXiv:2410.05355",
)
