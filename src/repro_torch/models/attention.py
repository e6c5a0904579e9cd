"""GQA attention: RoPE, qk-norm, logit soft-capping, sliding window, KV cache.

Counterpart of ``repro.models.attention``, with its dispatch: full-sequence
attention (forward, prefill) goes to the flash kernel (``kernels.ops``) when
``cfg.use_pallas`` is set, one static window covers every layer, and the
length is a multiple of 64; otherwise it is the plain q-chunked path.  That
dispatch is the reference's, not a fallback: a CUDA tensor that reaches the
kernel launches it or raises.  Decode is plain PyTorch, as in the reference.

Masked logits are -1e30, not -inf: an inactive decode slot (``pos == -1``)
masks every key, and -inf would make its don't-care logits NaN.

The KV cache is updated in place (the reference returns new arrays), and the
updated cache is returned as well.  ``_constrain_hd`` (the reference's
sharding constraint on the head width under a device mesh) has no
counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm, softcap

Params = Dict[str, torch.Tensor]


def init_attention(gen, cfg: ModelConfig, dtype, device="cpu") -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype, device=device),
        "wk": dense_init(gen, (d, kv * hd), dtype, device=device),
        "wv": dense_init(gen, (d, kv * hd), dtype, device=device),
        "wo": dense_init(gen, (h * hd, d), dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
    return p


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, kv, hd)
    v = (x @ p["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.encoder_only:
        return q, k, v
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(
    cfg: ModelConfig,
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Sk, KV, hd)
    v: torch.Tensor,              # (B, Sk, KV, hd)
    q_positions: torch.Tensor,    # (B, Sq) or (Sq,)
    k_positions: torch.Tensor,    # (B, Sk) or (Sk,)
    window: Optional[int],        # None = full attention
    causal: bool,
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    logits = torch.einsum(
        "bqgrd,bkgd->bgrqk", qg.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(hd)
    if cfg.attn_softcap:
        logits = softcap(logits, cfg.attn_softcap)
    qp = q_positions.reshape(-1, Sq).expand(B, Sq)
    kp = k_positions.reshape(-1, Sk).expand(B, Sk)
    rel = qp[:, :, None] - kp[:, None, :]                # (B, Sq, Sk)
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    logits = torch.where(mask[:, None, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H * hd).to(q.dtype)


def _attend_seq(cfg: ModelConfig, q, k, v, positions, window) -> torch.Tensor:
    """Full-sequence attention, q-chunked when configured (the reference's
    ``jax.checkpoint`` of a chunk has no counterpart: under ``cfg.remat``
    the layer's checkpoint in ``transformer.forward_hidden`` recomputes the
    chunks in the backward pass)."""
    B, S = q.shape[0], q.shape[1]
    causal = not cfg.encoder_only
    if cfg.use_pallas:
        # kernel path: needs one static window across layers (or all-full)
        ws = set(cfg.layer_windows())
        if len(ws) == 1:
            out = _flash_kernel_call(cfg, q, k, v, causal, next(iter(ws)))
            if out is not None:
                return out
    chunk = cfg.attn_chunk
    if chunk:
        while S % chunk:
            chunk //= 2
    if not chunk or S <= chunk:
        return _attend(cfg, q, k, v, positions, positions, window, causal)
    outs = [_attend(cfg, q[:, i:i + chunk], k, v, positions[i:i + chunk], positions,
                    window, causal)
            for i in range(0, S, chunk)]
    return torch.cat(outs, dim=1)


def _flash_kernel_call(cfg: ModelConfig, q, k, v, causal, w_static):
    """The flash kernel when the length allows (the reference's test
    ``S % 128 and S % 64``: a multiple of 64); None sends the caller to the
    plain path, as the reference does for unaligned lengths."""
    B, S = q.shape[0], q.shape[1]
    if S % 64:
        return None
    out = ops.flash_attention(q, k, v, causal=causal, window=w_static,
                              softcap=cfg.attn_softcap)
    return out.reshape(B, S, -1)


def attention_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill), causal unless encoder_only."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _attend_seq(cfg, q, k, v, positions, window) @ p["wo"]


def attention_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Like forward but also returns the (k, v) cache."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _attend_seq(cfg, q, k, v, positions, window) @ p["wo"], (k, v)


def attention_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                           # (B, 1, D) current token's hidden
    cache: Tuple[torch.Tensor, torch.Tensor],  # k, v (B, S, KV, hd); positions 0..S-1
    pos,                                       # int, or (B,) tensor per slot
    window: Optional[int] = None,
    static_window: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a KV cache; writes the new k/v at ``pos``.

    ``pos`` is an int (the whole batch at one position) or a ``(B,)`` tensor
    (the serving slot pool: every slot at its own position, ``-1`` for an
    inactive slot, which writes nothing and whose reads are all masked).
    With a scalar ``pos`` and one static window over every layer,
    ``static_window`` reads only the last ``W`` cache rows.
    """
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        return _attention_decode_slots(cfg, p, x, cache, pos, window)
    k_cache, v_cache = cache
    S = k_cache.shape[1]
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    if static_window is not None and static_window < S:
        W = static_window
        start = min(max(pos - W + 1, 0), S - W)
        k_read, v_read = k_cache[:, start:start + W], v_cache[:, start:start + W]
        k_positions = start + torch.arange(W, dtype=torch.int32, device=x.device)
    else:
        k_read, v_read = k_cache, v_cache
        k_positions = torch.arange(S, dtype=torch.int32, device=x.device)
    # beyond-pos rows are masked by the causal rel >= 0 test (q position == pos)
    out = _attend(cfg, q, k_read, v_read, positions, k_positions, window, causal=True)
    return out @ p["wo"], (k_cache, v_cache)


def _write_slots(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """cache[b, pos[b]] = new[b, 0] for every slot with pos[b] >= 0, in place
    and without a host sync (inactive slots rewrite their row 0 unchanged)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = pos.clamp(min=0).to(torch.int64)
    keep = (pos >= 0)[:, None, None]
    cache[rows, idx] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, idx])


def _attention_decode_slots(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                           # (B, 1, D) current token per slot
    cache: Tuple[torch.Tensor, torch.Tensor],  # k, v (B, S, KV, hd)
    pos: torch.Tensor,                         # (B,) per-slot position, -1 = inactive
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-slot decode: each batch row writes and reads at its own position.
    Reads stream the full cache: the causal test ``q_pos - k_pos >= 0``
    limits each slot to its own live prefix, and the sliding window (when
    configured) is enforced by the same relative-position mask."""
    k_cache, v_cache = cache
    S = k_cache.shape[1]
    positions = pos[:, None].to(torch.int32)              # (B, 1) q positions
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    _write_slots(k_cache, k_new, pos)
    _write_slots(v_cache, v_new, pos)
    k_positions = torch.arange(S, dtype=torch.int32, device=x.device)
    out = _attend(cfg, q, k_cache, v_cache, positions, k_positions, window, causal=True)
    return out @ p["wo"], (k_cache, v_cache)
