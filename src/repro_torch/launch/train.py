"""The model-size presets of ``repro.launch.train`` (``size_override``).

Only the presets are here, because ``launch/serve.py`` needs them.  The
trainer itself comes with ROADMAP Queue 1 items 9 (the distributed
HO-SGD step on ``torch.distributed``) and 11 (the model stack's loss).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def size_override(cfg: ModelConfig, preset: str) -> ModelConfig:
    """Depth/width presets so examples fit the local device."""
    if preset == "full":
        return cfg
    if preset == "100m":
        return cfg.with_(
            n_layers=max(cfg.pattern_period * 4, 8), d_model=768,
            n_heads=12, n_kv_heads=max(1, min(cfg.n_kv_heads, 4)),
            head_dim=64, d_ff=2048, dense_d_ff=min(cfg.dense_d_ff, 2048),
            vocab_size=min(cfg.vocab_size, 32768),
            n_experts=min(cfg.n_experts, 8), dt_rank=48,
            dtype="float32",
        )
    if preset == "smoke":
        return cfg.reduced()
    raise ValueError(preset)
