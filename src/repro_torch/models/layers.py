"""Initializers (the part of ``repro.models.layers`` the MLP slice needs).

Random numbers come from an explicit ``torch.Generator``, drawn on the CPU
and then moved, so a seed gives the same parameters on every device.  The
bits differ from JAX's threefry: parity tests carry JAX's initial parameters
across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math

import torch


def as_generator(gen) -> torch.Generator:
    """A ``torch.Generator``, or an int seed turned into a seeded one."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator().manual_seed(int(gen))


def dense_init(gen, shape, dtype=torch.float32, scale: float = 1.0,
               device="cpu") -> torch.Tensor:
    """Variance-scaling (fan-in) truncated-normal init on [-2, 2] std."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    x = torch.nn.init.trunc_normal_(torch.empty(tuple(shape), dtype=torch.float32),
                                    0.0, 1.0, -2.0, 2.0,
                                    generator=as_generator(gen))
    return (x * std).to(device=device, dtype=dtype)
