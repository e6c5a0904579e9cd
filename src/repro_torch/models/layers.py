"""Shared building blocks: norms, MLPs, rotary embeddings, initializers.

Counterpart of ``repro.models.layers``, with its casts: norms, rope and
softcap compute in float32 and cast back to the input's dtype; norms use the
``(1 + scale)`` parameterisation, and norm parameters are float32 whatever
the model's dtype.

Random numbers come from an explicit ``torch.Generator`` and are drawn on the
generator's device, then moved to ``device``: a CPU generator gives the same
parameters on every device, a CUDA generator draws on the card (what a model
of billions of parameters needs).  The bits differ from JAX's threefry:
parity tests carry JAX's initial parameters across with
``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# initialisation
# --------------------------------------------------------------------------- #
def as_generator(gen) -> torch.Generator:
    """A ``torch.Generator``, or an int seed turned into a seeded one."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator().manual_seed(int(gen))


def dense_init(gen, shape, dtype=torch.float32, scale: float = 1.0,
               device="cpu") -> torch.Tensor:
    """Variance-scaling (fan-in) truncated-normal init on [-2, 2] std."""
    gen = as_generator(gen)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    x = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if not is_fake(x):
        # a fake tensor (the dry run) has no values to draw, and the draw's
        # rejection loop reads them
        x = torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(device=device, dtype=dtype)


def embed_init(gen, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    gen = as_generator(gen)
    x = torch.randn(tuple(shape), dtype=torch.float32, device=gen.device, generator=gen)
    return (x * 0.02).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    # (1 + scale) parameterisation (gemma/qwen style): init scale = 0 is identity
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32)) + bias.to(torch.float32)).to(dt)


def init_norm(cfg: ModelConfig, d: int, device="cpu") -> Params:
    p = {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def init_mlp(gen, cfg: ModelConfig, d_ff: int, dtype, device="cpu") -> Params:
    d = cfg.d_model
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "wg": dense_init(gen, (d, d_ff), dtype, device=device),
            "wu": dense_init(gen, (d, d_ff), dtype, device=device),
            "wd": dense_init(gen, (d_ff, d), dtype, device=device),
        }
    return {
        "wu": dense_init(gen, (d, d_ff), dtype, device=device),
        "wd": dense_init(gen, (d_ff, d), dtype, device=device),
    }


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wu"])
    else:
        h = F.gelu(x @ p["wu"], approximate="tanh")
    return h @ p["wd"]


# --------------------------------------------------------------------------- #
# rotary position embeddings
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                          # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                            # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)
