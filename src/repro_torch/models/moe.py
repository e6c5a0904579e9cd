"""Token-choice top-k MoE with capacity-based gather dispatch.

Counterpart of ``repro.models.moe``: every expert computes a fixed capacity
of ``C`` token rows, so the expert products are dense batched GEMMs
``(E, C, d) x (E, d, f)`` (``torch.bmm``).  Routing follows the reference
step for step: float32 router softmax, top-k, gates renormalised over the
k picks, a Switch-style load-balance aux loss, and each (token, slot)'s
place in its expert's buffer from a stable sort by expert.  A route whose
place is past ``C`` is dropped: it writes no slot and its gate weight is 0.

Two rules are the reference's, not PyTorch's defaults:

* ties in the top k go to the lower expert index (``jax.lax.top_k``);
  ``torch.topk`` breaks them otherwise, so the top k is taken with a stable
  descending sort;
* a dropped route's combine gather reads row ``C - 1`` of its expert (JAX
  clamps an index past the end), and its zero weight zeroes it; an empty
  slot reads token 0 and is zeroed by its validity mask.

The reference's ``_expert_spec`` and ``_constrain`` (sharding constraints
that pin the dispatch tensors to the expert weights' mesh placement) have
no meaning on one device and no counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: ``ceil(T * k * capacity_factor / E)`` rounded up to
    a multiple of 8, at least 8.  ``n_tokens`` counts pad tokens too."""
    cap = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def init_moe(gen, cfg: ModelConfig, dtype, device="cpu") -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (d, e), torch.float32, device=device),
        "wg": dense_init(gen, (e, d, f), dtype, device=device),
        "wu": dense_init(gen, (e, d, f), dtype, device=device),
        "wd": dense_init(gen, (e, f, d), dtype, device=device),
    }


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, largest
    first, ties to the lower index (``jax.lax.top_k``'s rule)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def route(cfg: ModelConfig, p: Params, xf: torch.Tensor):
    """xf (T, D) -> (gate (T, k) float32, expert ids (T, k), aux loss)."""
    E = cfg.n_experts
    logits = xf.to(torch.float32) @ p["router"]                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_ids = top_k(probs, cfg.top_k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                       # (E,)
    ce = torch.nn.functional.one_hot(expert_ids, E).to(torch.float32).sum(1).mean(0)
    return gate, expert_ids, E * torch.sum(me * ce)


def dispatch(expert_ids: torch.Tensor, E: int, C: int):
    """The place of each (token, slot) in its expert's buffer, by a stable
    sort of the t-major routes by expert: (flat_e, flat_pos, keep) of shape
    (T*k,), and the (E, C) slot tables ``tok_for_slot``, ``slot_valid``."""
    T, k = expert_ids.shape
    dev = expert_ids.device
    flat_e = expert_ids.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    starts = torch.searchsorted(e_sorted, torch.arange(E, dtype=flat_e.dtype, device=dev))
    ar = torch.arange(T * k, dtype=torch.int64, device=dev)
    flat_pos = torch.empty_like(ar)
    flat_pos[order] = ar - starts[e_sorted]
    keep = flat_pos < C
    # the reference's scatter with mode="drop": a route past capacity writes
    # into a spare column C, which is cut off (no host sync on a mask)
    col = flat_pos.clamp(max=C)
    tok_for_slot = torch.zeros((E, C + 1), dtype=torch.int64, device=dev)
    tok_for_slot[flat_e, col] = ar // k
    slot_valid = torch.zeros((E, C + 1), dtype=torch.bool, device=dev)
    slot_valid[flat_e, col] = keep
    return flat_e, flat_pos, keep, tok_for_slot[:, :C], slot_valid[:, :C]


def experts(p: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """The swiglu experts on their buffers: (E, C, D) -> (E, C, D)."""
    g = torch.bmm(expert_in, p["wg"])
    h = g * torch.sigmoid(g) * torch.bmm(expert_in, p["wu"])
    return torch.bmm(h, p["wd"])


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x (B, S, D) -> (y (B, S, D), load-balance aux loss, a float32 scalar)."""
    B, S, D = x.shape
    T, k, E = B * S, cfg.top_k, cfg.n_experts
    C = moe_capacity(cfg, T)
    xf = x.reshape(T, D)
    gate, expert_ids, aux = route(cfg, p, xf)
    with torch.no_grad():
        flat_e, flat_pos, keep, tok_for_slot, slot_valid = dispatch(expert_ids, E, C)
    expert_in = xf[tok_for_slot] * slot_valid[..., None].to(x.dtype)   # (E, C, D)
    out_e = experts(p, expert_in)
    # combine: each (token, slot)'s expert row, a dropped route's clamped to C - 1
    gathered = out_e[flat_e, flat_pos.clamp(max=C - 1)]                 # (T*k, D)
    w = (gate.reshape(T * k) * keep.to(torch.float32)).to(x.dtype)
    y = (gathered * w[:, None]).reshape(T, k, D).sum(dim=1)
    return y.reshape(B, S, D), aux
