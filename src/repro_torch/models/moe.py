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

Partitioned over the ``model`` axis (``moe_partial``, the training loss on
sharded placements; what the reference's ``_expert_spec`` and
``_constrain`` pin for its compiler): the routing runs on the replicated
activations, the same on every rank; under ``moe_sharding='tensor'`` a
rank's experts hold its columns of the hidden dim (``wg``/``wu``
column-parallel, ``wd`` row-parallel), under ``'expert'`` a rank runs its
own experts.  Either way the rank's combine of its float32 expert rows is a
partial of the layer's output, summed by one all-reduce of (T, D) after the
combine, not of (E, C, D).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import row_partial
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


def _expert_hidden(p: Params, expert_in: torch.Tensor) -> torch.Tensor:
    g = torch.bmm(expert_in, p["wg"])
    return g * torch.sigmoid(g) * torch.bmm(expert_in, p["wu"])


def experts(p: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """The swiglu experts on their buffers: (E, C, D) -> (E, C, D)."""
    return torch.bmm(_expert_hidden(p, expert_in), p["wd"])


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


def moe_partial(cfg: ModelConfig, p: Params, x: torch.Tensor, x_in: torch.Tensor, tp):
    """This rank's float32 partial of the layer's output (B, S, D) and the
    aux loss: routed on ``x`` (replicated), its experts run on ``x_in``
    (``x`` after ``tp.enter``), the gates entering the rank's part too (each
    rank's combine sees only its own expert rows).  ``p["wg"]``'s leading
    dim is the rank's experts: all E (``'tensor'``: its hidden columns) or
    E/ms from ``tp.rank * E/ms`` (``'expert'``)."""
    B, S, D = x.shape
    T, k, E = B * S, cfg.top_k, cfg.n_experts
    C = moe_capacity(cfg, T)
    gate, expert_ids, aux = route(cfg, p, x.reshape(T, D))
    with torch.no_grad():
        flat_e, flat_pos, keep, tok_for_slot, slot_valid = dispatch(expert_ids, E, C)
    n = p["wg"].shape[0]
    e0 = 0 if n == E else tp.rank * n
    xf = x_in.reshape(T, D)
    expert_in = xf[tok_for_slot[e0:e0 + n]] * slot_valid[e0:e0 + n, :, None].to(x.dtype)
    out_e = row_partial(_expert_hidden(p, expert_in), p["wd"])
    local = flat_e - e0
    mine = (local >= 0) & (local < n)
    gathered = out_e[local.clamp(0, n - 1), flat_pos.clamp(max=C - 1)]   # (T*k, D)
    w = tp.enter(gate).reshape(T * k) * (keep & mine).to(torch.float32)
    y = (gathered * w[:, None]).reshape(T, k, D).sum(dim=1)
    return y.reshape(B, S, D), aux
