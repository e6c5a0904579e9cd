"""Gradient codecs for the FO all-reduce: QSGD, signSGD, top-k, in PyTorch.

Counterpart of ``repro.dist.compress``.  Each codec is an (encode, decode)
pair over flat float32 vectors plus a bytes-on-the-wire estimate that feeds
the ``CommLedger`` (QSGD: Alistarh et al. 2017; signSGD: Bernstein et al.
2018; top-k: Aji & Heafield 2017).

Randomness: the reference keys its draws with ``jax.random`` (threefry),
which the port does not reproduce.  A key here is a uint32 int, derived with
``core.directions.fold`` from the same identities (seed, step, worker, leaf),
and ``uniform(key, shape, device)`` draws from a ``torch.Generator`` seeded
with it on the tensor's device -- so the draw is the same run to run on one
device, and differs between the CPU and the card.  The draw is kept apart
from what is done with it: QSGD's stochastic rounding is ``u < p`` on those
uniforms, exactly ``jax.random.bernoulli``'s rule, so a test can hand the
reference's uniforms to the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def uniform(key: int, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) from a generator seeded with ``key``."""
    gen = torch.Generator(device=device).manual_seed(int(key))
    return torch.rand(tuple(shape), generator=gen, device=device)


@dataclass(frozen=True)
class Compressor:
    """encode: (flat fp32, key) -> code tuple; decode: code -> flat fp32."""
    name: str
    encode: Callable[[torch.Tensor, int], Any]
    decode: Callable[[Any], torch.Tensor]
    nbytes: Callable[[int], int]          # d -> wire bytes per worker


# --------------------------------------------------------------------------- #
# QSGD — s-level stochastic quantization
# --------------------------------------------------------------------------- #
def qsgd_levels(g: torch.Tensor, s: int, u: torch.Tensor):
    """QSGD's code of ``g`` given the uniforms ``u`` (the draw-free part):
    ``(norm, sign, level)`` with ``level = floor(|g|/norm*s) + (u < frac)``."""
    norm = torch.sqrt(torch.sum(g * g)) + 1e-30
    level = g.abs() / norm * s
    lower = torch.floor(level)
    bump = u < (level - lower)
    q = (lower + bump.to(torch.float32)).to(torch.int8 if s < 127 else torch.int32)
    return norm, torch.sign(g).to(torch.int8), q


def qsgd(s: int = 4) -> Compressor:
    bits = max(1, math.ceil(math.log2(s + 1))) + 1   # level bits + sign bit

    def encode(g: torch.Tensor, key) -> Tuple[torch.Tensor, ...]:
        return qsgd_levels(g, s, uniform(key, g.shape, g.device))

    def decode(code) -> torch.Tensor:
        norm, sign, q = code
        return sign.to(torch.float32) * norm * q.to(torch.float32) / s

    return Compressor(f"qsgd{s}", encode, decode,
                      nbytes=lambda d: 4 + (d * bits + 7) // 8)


# --------------------------------------------------------------------------- #
# signSGD — 1 bit per coordinate + one scale
# --------------------------------------------------------------------------- #
def signsgd() -> Compressor:
    def encode(g: torch.Tensor, key) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.mean(g.abs()), torch.sign(g).to(torch.int8)

    def decode(code) -> torch.Tensor:
        scale, sign = code
        return scale * sign.to(torch.float32)

    return Compressor("signsgd", encode, decode,
                      nbytes=lambda d: 4 + (d + 7) // 8)


# --------------------------------------------------------------------------- #
# top-k — k (index, value) pairs
# --------------------------------------------------------------------------- #
def topk(frac: float = 0.01, k: Optional[int] = None) -> Compressor:
    def k_of(d: int) -> int:
        return max(1, min(d, k if k is not None else int(round(frac * d))))

    def encode(g: torch.Tensor, key) -> Tuple[torch.Tensor, torch.Tensor, int]:
        idx = torch.topk(g.abs(), k_of(g.numel())).indices
        return idx.to(torch.int32), g[idx], g.numel()

    def decode(code) -> torch.Tensor:
        idx, vals, d = code
        out = torch.zeros((d,), dtype=torch.float32, device=vals.device)
        out[idx.to(torch.int64)] = vals.to(torch.float32)
        return out

    return Compressor("topk", encode, decode,
                      nbytes=lambda d: 8 * k_of(d))      # int32 idx + fp32 val


_REGISTRY = {"qsgd": qsgd, "signsgd": signsgd, "topk": topk}


def get_compressor(name: Optional[str], **kw) -> Optional[Compressor]:
    """'qsgd' | 'signsgd' | 'topk' | 'none'/None -> Compressor or None."""
    if name is None or name in ("none", ""):
        return None
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; options: "
                         f"{sorted(_REGISTRY)} or 'none'")
    return _REGISTRY[name](**kw)


def compress_tree(comp: Compressor, tree: Any, key: int) -> Tuple[Any, int]:
    """decode(encode(leaf)) every leaf (leaf i keyed ``fold(key, i)``);
    returns (tree', total wire bytes), each leaf keeping shape and dtype."""
    # deferred: importing repro_torch.core imports core.rounds, which imports
    # this module
    from repro_torch.core.directions import fold

    leaves, treedef = tree_flatten(tree)
    out, nbytes = [], 0
    for i, g in enumerate(leaves):
        flat = g.reshape(-1).to(torch.float32)
        dec = comp.decode(comp.encode(flat, fold(key, i)))
        out.append(dec.reshape(g.shape).to(g.dtype))
        nbytes += comp.nbytes(flat.numel())
    return tree_unflatten(treedef, out), nbytes
