"""Model FLOPs, frozen here: what ``mfu`` counts, from a configuration's numbers alone.

The convention is the one of PaLM's model-FLOPs utilisation (Chowdhery et al.,
arXiv:2204.02311, appendix B) and Megatron-LM's accounting (Narayanan et al.,
arXiv:2104.04473, section 5.1):

* a matrix product counts 2 FLOPs per multiply-add: every projection of
  attention (q, k, v, o), of the Mamba mixer (in_proj, x_proj, dt_w,
  out_proj) and of the MLP, and the output head;
* attention counts QK^T and PV, 2 * head_dim multiply-adds per (query, key)
  pair and query head, over the pairs that the causal mask and the layer's
  window leave;
* elementwise work counts nothing: norms, rotary embeddings, softmax, the
  depthwise convolution, the selective recurrence, activations, the loss;
* a training step's backward counts twice its forward (a first-order step is
  3 forwards); a zeroth-order step is its two forward evaluations;
  recomputation (remat, a prefill's recomputed SSM state) counts nothing;
* serving counts forwards only: a prefill over its prompt with the head at
  its last position, a decode token over one position with the head.
"""
from __future__ import annotations

from typing import Dict, Optional


def _windows(cfg: Dict):
    L = cfg["n_layers"]
    if cfg["arch_type"] == "ssm":
        return []
    pat, w = cfg["layer_pattern"], cfg["window"]
    if pat == "global":
        return [None] * L
    if pat == "local":
        return [w] * L
    if pat == "local_global":
        return [w if i % 2 == 0 else None for i in range(L)]
    if pat == "hymba":
        return [None if i in {0, L // 2, L - 1} else w for i in range(L)]
    raise ValueError(pat)


def layer_macs(cfg: Dict) -> int:
    """Multiply-adds of one layer's projections for one token."""
    d, arch = cfg["d_model"], cfg["arch_type"]
    macs = 0
    if arch != "ssm":
        h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        macs += d * (h + 2 * kv) * hd + h * hd * d
    if arch in ("ssm", "hybrid"):
        di, n = cfg["ssm_expand"] * d, cfg["ssm_state"]
        dtr = cfg["dt_rank"] or max(1, d // 16)
        macs += d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
    if cfg["d_ff"]:
        mats = 3 if cfg["activation"] in ("swiglu", "geglu") else 2
        macs += mats * d * cfg["d_ff"]
    return macs


def pairs(window: Optional[int], first: int, count: int) -> int:
    """(query, key) pairs of queries at positions ``first .. first+count-1``
    under a causal mask and ``window`` (None: full)."""
    total = 0
    lo, hi = first, first + count           # position i attends min(i + 1, window) keys
    if window is None or window >= hi:
        return (lo + 1 + hi) * count // 2
    cut = min(max(window - 1, lo), hi)      # positions below cut are under the window
    total += (lo + 1 + cut) * (cut - lo) // 2
    total += window * (hi - cut)
    return total


def forward(cfg: Dict, first: int, count: int, head_positions: int) -> int:
    """FLOPs of one sequence's forward over positions ``first ..
    first+count-1`` (earlier positions cached), with the head at
    ``head_positions`` of them."""
    macs = cfg["n_layers"] * layer_macs(cfg) * count
    if cfg["arch_type"] != "ssm":
        per_pair = cfg["n_heads"] * 2 * cfg["head_dim"]
        macs += sum(pairs(w, first, count) for w in _windows(cfg)) * per_pair
    macs += head_positions * cfg["d_model"] * cfg["vocab_size"]
    return 2 * macs


def train_step(cfg: Dict, sequences: int, seq_len: int, first_order: bool) -> int:
    one = sequences * forward(cfg, 0, seq_len, seq_len)
    return 3 * one if first_order else 2 * one


def prefill(cfg: Dict, prompt_len: int) -> int:
    return forward(cfg, 0, prompt_len, 1)


def decode_token(cfg: Dict, position: int) -> int:
    return forward(cfg, position, 1, 1)
