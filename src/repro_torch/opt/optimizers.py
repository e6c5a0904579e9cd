"""Optimizers and LR schedules over parameter trees, in PyTorch.

Counterpart of ``repro.opt.optimizers``.  An ``Optimizer`` is an
``(init, update)`` pair; ``update`` consumes the gradient estimate (first- or
zeroth-order) and returns parameter deltas, which ``apply_deltas`` adds.
Schedules return float32 0-d tensors, as the JAX schedules return float32
arrays.  Updates run outside autograd (``torch.no_grad``) at the call sites.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_map

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, t) -> (deltas, state)
    # introspection for fused update paths (the flat engine's in-kernel SGD
    # commit): ``kind`` names the rule, ``hyper`` carries what a fused
    # implementation needs ('schedule', 'momentum', ...)
    kind: str = "custom"
    hyper: dict | None = None


def _tree_zeros_like(tree):
    return tree_map(lambda x: torch.zeros_like(x, dtype=_F32), tree)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


# --------------------------------------------------------------------------- #
# schedules
# --------------------------------------------------------------------------- #
def const_schedule(lr: float):
    return lambda t: _f32(lr)


def invsqrt_schedule(lr: float, warmup: int = 0):
    def f(t):
        s = torch.sqrt(_f32(warmup + 1) / (_f32(t) + (warmup + 1)))
        return _f32(lr) * s
    return f


def cosine_schedule(lr: float, total: int, warmup: int = 0, floor: float = 0.1):
    def f(t):
        t = _f32(t)
        warm = torch.clamp(t / max(warmup, 1), max=1.0)
        frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return _f32(lr) * torch.where(t < warmup, warm, cos)
    return f


def theorem_lr(B: int, m: int, N: int, L: float = 1.0) -> float:
    """Theorem 1 step size: alpha_t = sqrt(B*m) / (L*sqrt(N))."""
    return math.sqrt(B * m) / (L * math.sqrt(N))


# --------------------------------------------------------------------------- #
# SGD (+ momentum)
# --------------------------------------------------------------------------- #
def sgd(schedule, momentum: float = 0.0):
    def init(params):
        return _tree_zeros_like(params) if momentum else ()

    def update(grads, state, params, t):
        lr = schedule(t)
        if momentum:
            state = tree_map(lambda v, g: momentum * v + g.to(_F32), state, grads)
            deltas = tree_map(lambda v: -lr * v, state)
        else:
            deltas = tree_map(lambda g: -lr * g.to(_F32), grads)
        return deltas, state

    return Optimizer(init, update, kind="sgd",
                     hyper={"schedule": schedule, "momentum": float(momentum)})


# --------------------------------------------------------------------------- #
# Adam
# --------------------------------------------------------------------------- #
def adam(schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params):
        return (_tree_zeros_like(params), _tree_zeros_like(params))

    def update(grads, state, params, t):
        mu, nu = state
        tf = _f32(t + 1)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(_F32), mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(_F32)),
                      nu, grads)
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        lr = schedule(t)
        deltas = tree_map(
            lambda m, v: -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return deltas, (mu, nu)

    return Optimizer(init, update, kind="adam",
                     hyper={"schedule": schedule, "b1": b1, "b2": b2, "eps": eps})


def apply_deltas(params, deltas):
    return tree_map(lambda p, d: (p.to(_F32) + d).to(p.dtype), params, deltas)
