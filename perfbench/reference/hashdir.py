"""A frozen copy of HO-SGD's pre-shared-seed directions, for the plain reference.

Leaf ``i`` of worker ``w`` at step ``t`` under seed ``s`` takes the salt
``fold(s, t, w, i)``; its element ``j`` (row-major, counting from 0, mod
2**32) is a standard normal from two 32-bit hashes of ``j`` and the salt and
Box-Muller's cosine branch, in float32.  This is the arithmetic of
``repro_torch.core.directions`` (and of the JAX package's
``repro.core.directions``), copied so that the reference imports nothing of
the program.  uint32 words are held in int64 and masked after every add and
multiply; a multiply by a 32-bit constant goes by its 16-bit halves, so no
intermediate passes 2**48.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_SALT2 = 0x85EBCA6B
_XOR2 = 0xC2B2AE35
_TWO_PI = 6.2831854820251465      # 2*pi rounded to float32, written exactly


def _u32(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & MASK
    return int(v) & MASK


def _mul32(a, b: int):
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK


def mix32(x):
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def fold(*ints) -> int:
    acc = 0
    for v in ints:
        acc = mix32(acc ^ _mul32(_u32(v), _GOLDEN))
    return acc


def gaussians(start: int, n: int, salt: int, device) -> torch.Tensor:
    """``n`` float32 normals of counters ``start .. start + n - 1`` under ``salt``."""
    idx = (torch.arange(n, dtype=torch.int64, device=device) + start) & MASK
    h1 = mix32((_mul32(idx, _GOLDEN) + salt) & MASK)
    h2 = mix32((_mul32(idx, _SALT2) + (salt ^ _XOR2)) & MASK)
    u1 = (h1 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    u2 = (h2 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def blocks(numel: int, block: int):
    """``(start, length)`` of consecutive blocks covering ``numel`` counters."""
    for s in range(0, numel, block):
        yield s, min(block, numel - s)
