"""Architecture registry: ``--arch <id>`` ids map to published configs.

Copy of ``repro.configs``; every ``<arch>.py`` here is a copy of its
counterpart there.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    ModelConfig,
    ShapeConfig,
    SHAPES,
    config_for_shape,
    shape_applicable,
)

_MODULES = {
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
