"""Pre-shared-seed random directions (the paper's §3 trick), in PyTorch.

Counterpart of ``repro.core.directions``.  A direction is a pure function of
``(seed, iteration, worker, leaf, element position)`` through a counter-based
32-bit hash, so every worker regenerates every other worker's direction from
the one pre-shared integer ``seed``.  The hash is bit-identical to the JAX
package's; the Gaussians agree to a few ulps (``log``/``cos`` differ by ulps
between math libraries).

uint32 arithmetic without uint32 tensors: PyTorch's CPU backend implements
neither ``>>`` nor ``+`` for ``torch.uint32``, so words are held in int64 in
``[0, 2**32)`` and every add and multiply is masked with ``& 0xFFFFFFFF``.
A multiply by a 32-bit constant is split into its 16-bit halves
(``_mul32``) so that no intermediate exceeds 2**48: nothing relies on signed
int64 overflow.  The same functions accept plain Python ints, which is how the
per-leaf salts are folded on the host.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten  # noqa: F401

MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_SALT2 = 0x85EBCA6B
_XOR2 = 0xC2B2AE35
# 2*pi rounded to float32 (JAX's weakly typed Python float becomes this f32
# value inside a float32 product); written as the exact double of that f32 so
# the multiply is the same whatever precision a backend casts the scalar to
_TWO_PI = 6.2831854820251465


def _u32(v):
    """An int or integer tensor as an int64-held uint32 word."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK
    return int(v) & MASK


def _mul32(a, b: int):
    """``a * b mod 2**32`` for a word ``a`` and a 32-bit constant ``b``.

    ``a*b = a*lo + (a*hi << 16)``: ``a*lo < 2**48`` and only the low 16 bits
    of ``a*hi`` survive the shift, so int64 never overflows.
    """
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK


def mix32(x):
    """Full-avalanche 32-bit integer hash (lowbias32)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def fold(*ints):
    """Combine integers into one uint32 salt (order-sensitive)."""
    acc = 0
    for v in ints:
        acc = mix32(acc ^ _mul32(_u32(v), _GOLDEN))
    return acc


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in (0, 1): top 24 bits, never exactly 0."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25


def gaussian_from_counters(idx: torch.Tensor, salt) -> torch.Tensor:
    """Standard normals for int64-held uint32 counters ``idx`` under ``salt``
    (an int or a tensor broadcastable against ``idx``); Box–Muller, cos
    branch, all in float32."""
    salt = _u32(salt)
    h1 = mix32((_mul32(idx, _GOLDEN) + salt) & MASK)
    h2 = mix32((_mul32(idx, _SALT2) + (salt ^ _XOR2)) & MASK)
    u1 = _uniform01(h1)
    u2 = _uniform01(h2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def gaussian_from_salt(shape: Tuple[int, ...], salt, offset=0, *,
                       device=None) -> torch.Tensor:
    """Standard-normal tensor of ``shape`` from the counter hash.

    The row-major flat index plus ``offset`` is the counter, so one leaf can
    be generated in pieces.  Counters wrap mod 2**32 (leaves beyond 2**32
    elements repeat), as in the JAX package and the CUDA kernels.
    ``device`` defaults to the salt's device when it is a tensor, else CPU.
    """
    if device is None:
        device = salt.device if isinstance(salt, torch.Tensor) else "cpu"
    n = 1
    for s in shape:
        n *= int(s)
    idx = (torch.arange(n, dtype=torch.int64, device=device) + _u32(offset)) & MASK
    return gaussian_from_counters(idx, salt).reshape(tuple(shape))


# --------------------------------------------------------------------------- #
# whole-parameter-tree directions
# --------------------------------------------------------------------------- #
def tree_dim(params: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def leaf_salts(params: Any, seed: int, t, worker) -> List[int]:
    return [fold(seed, t, worker, i) for i in range(len(tree_leaves(params)))]


def raw_direction(params: Any, seed: int, t, worker) -> Any:
    """Unnormalized float32 Gaussian direction tree, shaped like ``params``."""
    leaves, treedef = tree_flatten(params)
    vs = [gaussian_from_salt(tuple(x.shape), fold(seed, t, worker, i),
                             device=x.device)
          for i, x in enumerate(leaves)]
    return tree_unflatten(treedef, vs)


def sphere_direction(params: Any, seed: int, t, worker) -> Any:
    """Uniform-on-the-unit-sphere direction over the whole d-dim tree."""
    v = raw_direction(params, seed, t, worker)
    sumsq = sum(torch.sum(torch.square(x)) for x in tree_leaves(v))
    inv = torch.rsqrt(sumsq + 1e-30)
    return tree_map(lambda x: x * inv, v)


def tree_axpy(a, x_tree, y_tree):
    """y + a*x, cast back to y's dtypes (params stay in their own dtype)."""
    return tree_map(
        lambda x, y: (y.to(torch.float32) + a * x.to(torch.float32)).to(y.dtype),
        x_tree, y_tree)
