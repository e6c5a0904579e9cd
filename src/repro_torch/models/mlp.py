"""The paper's §5.2 experiment model: a 2-layer tanh classifier, in PyTorch.

Counterpart of ``repro.models.mlp``.  Parameters are a plain dict; it
flattens in sorted-key order ``b1, b2, b3, w1, w2, w3``, as ``jax.tree``
flattens the JAX model's dict, so both packages hash the same leaf indices.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import as_generator, dense_init


def init_mlp_classifier(gen, n_features: int, n_classes: int,
                        hidden: int = 1300, dtype=torch.float32,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Random MLP parameters from ``gen`` (a ``torch.Generator`` or a seed)."""
    dev = resolve_device(device)
    g = as_generator(gen)
    return {
        "w1": dense_init(g, (n_features, hidden), dtype, device=dev),
        "b1": torch.zeros((hidden,), dtype=dtype, device=dev),
        "w2": dense_init(g, (hidden, hidden), dtype, device=dev),
        "b2": torch.zeros((hidden,), dtype=dtype, device=dev),
        "w3": dense_init(g, (hidden, n_classes), dtype, device=dev),
        "b3": torch.zeros((n_classes,), dtype=dtype, device=dev),
    }


def mlp_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


def mlp_loss(params: Dict, batch: Dict) -> torch.Tensor:
    """Mean cross-entropy as logsumexp minus the gold logit."""
    logits = mlp_logits(params, batch["x"])
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"].long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def mlp_accuracy(params: Dict, batch: Dict) -> torch.Tensor:
    pred = torch.argmax(mlp_logits(params, batch["x"]), dim=-1)
    return torch.mean((pred == batch["y"].long()).to(torch.float32))
