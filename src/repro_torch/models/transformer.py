"""Decoder stack: the dense and SSM architectures of ``repro.models.transformer``.

Layer parameters are stacked on a leading ``n_layers`` axis, as the
reference's ``vmap`` init makes them, so a JAX ``init_model`` tree carries
over leaf for leaf (``repro_torch.convert``).  A Python loop over the layers
takes the place of ``lax.scan``; per-layer windows are Python ints
(``FULL_WINDOW`` = 2**30 means no window).  Caches (attention's k and v, the
SSM's conv and ssm states) are updated in place.

Ported: ``arch_type`` ``"dense"`` and ``"ssm"`` (mamba-1 layers,
``models.ssm``) with ``frontend="none"``: the forward pass, prefill and
decode for serving.  MoE and hybrid layers and the vision and audio
frontends raise ``NotImplementedError`` (ROADMAP Queue 1 item 11); the loss
comes with the trainer, ``launch/train.py`` (the same item).

Entry points that make tensors (``init_model``, ``init_caches``) run on the
card unless the caller asks for ``device="cpu"``; without a card the default
raises (``device.resolve_device``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    as_generator,
    embed_init,
    init_mlp,
    init_norm,
    softcap,
)
from repro_torch.tree import tree_map

Params = Dict
FULL_WINDOW = 1 << 30


def check_supported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "ssm") or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r}, frontend={cfg.frontend!r} is "
            "not ported yet (ROADMAP Queue 1 item 11: moe.py, hybrid layers and "
            "the vision/audio frontends); dense and SSM decoders are")


def windows_array(cfg: ModelConfig) -> torch.Tensor:
    return torch.tensor(
        [FULL_WINDOW if w is None else int(w) for w in cfg.layer_windows()],
        dtype=torch.int32)


def uniform_static_window(cfg: ModelConfig) -> Optional[int]:
    """The single static window if every layer shares one, else None."""
    ws = set(cfg.layer_windows())
    if len(ws) == 1 and None not in ws:
        return int(next(iter(ws)))
    return None


def _layers(cfg: ModelConfig, params: Params) -> List[Tuple[Params, int]]:
    """(per-layer parameter views, window) for each layer, in order."""
    stacked = params["layers"]
    return [(tree_map(lambda x, i=i: x[i], stacked), int(w))
            for i, w in enumerate(windows_array(cfg).tolist())]


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def _init_layer(gen, cfg: ModelConfig, dtype, device) -> Params:
    p: Params = {
        "norm1": init_norm(cfg, cfg.d_model, device),
        "norm2": init_norm(cfg, cfg.d_model, device),
    }
    if cfg.post_norms:
        p["post_norm1"] = init_norm(cfg, cfg.d_model, device)
        p["post_norm2"] = init_norm(cfg, cfg.d_model, device)
    if cfg.has_attention:
        p["attn"] = attn.init_attention(gen, cfg, dtype, device)
    if cfg.has_ssm:
        p["mamba"] = ssm_mod.init_mamba(gen, cfg, dtype, device)
    if cfg.d_ff:
        p["mlp"] = init_mlp(gen, cfg, cfg.d_ff, dtype, device)
    return p


def init_model(gen, cfg: ModelConfig, device="cuda") -> Params:
    """Random parameters from ``gen`` (a ``torch.Generator`` or an int seed),
    drawn on the generator's device and placed on ``device``.  The stacked
    layer tensors are filled one layer at a time, so the largest temporary
    is one layer's matrix."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = as_generator(gen)
    dtype = getattr(torch, cfg.dtype)
    params: Params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device)}
    layers = None
    for i in range(cfg.n_layers):
        lp = _init_layer(gen, cfg, dtype, device)
        if layers is None:
            layers = tree_map(lambda x: torch.empty((cfg.n_layers, *x.shape), dtype=x.dtype,
                                                    device=x.device), lp)
        tree_map(lambda dst, x, i=i: dst[i].copy_(x), layers, lp)
    params["layers"] = layers
    params["final_norm"] = init_norm(cfg, cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return params


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def _ffn(cfg: ModelConfig, lp: Params, xn: torch.Tensor) -> torch.Tensor:
    if cfg.d_ff:
        return apply_mlp(cfg, lp["mlp"], xn)
    return torch.zeros_like(xn)


def _mix(cfg: ModelConfig, lp: Params, xn: torch.Tensor, window: int) -> torch.Tensor:
    """Sequence-mixing sublayer: attention or mamba."""
    if cfg.arch_type == "ssm":
        return ssm_mod.mamba_forward(cfg, lp["mamba"], xn)
    return attn.attention_forward(cfg, lp["attn"], xn, window)


def _block(cfg: ModelConfig, lp: Params, x: torch.Tensor, window: int):
    mix = _mix(cfg, lp, apply_norm(cfg, lp["norm1"], x), window)
    if cfg.post_norms:
        mix = apply_norm(cfg, lp["post_norm1"], mix)
    x = x + mix
    ff = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], x))
    if cfg.post_norms:
        ff = apply_norm(cfg, lp["post_norm2"], ff)
    return x + ff, torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------- #
# embedding / inputs
# --------------------------------------------------------------------------- #
def embed_batch(cfg: ModelConfig, params: Params, batch: Dict) -> torch.Tensor:
    check_supported(cfg)
    return params["embed"][batch["tokens"]] * math.sqrt(cfg.d_model)


def compute_logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, params["final_norm"], h)
    head = params["embed"].T if "head" not in params else params["head"]
    logits = h @ head
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def forward_hidden(cfg: ModelConfig, params: Params, h: torch.Tensor):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp, win in _layers(cfg, params):
        h, a = _block(cfg, lp, h, win)
        aux = aux + a
    return h, aux


def forward_logits(cfg: ModelConfig, params: Params, batch: Dict):
    h = embed_batch(cfg, params, batch)
    h, aux = forward_hidden(cfg, params, h)
    return compute_logits(cfg, params, h), aux


# --------------------------------------------------------------------------- #
# serving: prefill + single-token decode with stacked per-layer caches
# --------------------------------------------------------------------------- #
def init_caches(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                device="cuda") -> Dict:
    """Zero caches, stacked over the layers: attention's k and v ``(L,
    batch, seq_len, KV, hd)``; an SSM's conv state ``(L, batch, K - 1,
    d_inner)`` in ``dtype`` and ssm state ``(L, batch, d_inner, n)`` in
    float32 (no sequence axis: ``seq_len`` does not size them)."""
    check_supported(cfg)
    device = resolve_device(device)
    L = cfg.n_layers
    caches: Dict = {}
    if cfg.has_attention:
        shape = (L, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
        caches["k"] = torch.zeros(shape, dtype=dtype, device=device)
        caches["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.has_ssm:
        caches["conv"] = torch.zeros((L, batch, cfg.ssm_conv - 1, cfg.d_inner),
                                     dtype=dtype, device=device)
        caches["ssm"] = torch.zeros((L, batch, cfg.d_inner, cfg.ssm_state),
                                    dtype=torch.float32, device=device)
    return caches


def _block_decode(cfg: ModelConfig, lp: Params, x, pos, cache_l: Dict, window: int):
    """One layer of decode; writes this layer's cache rows (attention) or
    states (SSM: every row, an inactive slot's too, as in the reference) in
    place."""
    xn = apply_norm(cfg, lp["norm1"], x)
    if cfg.arch_type == "ssm":
        mix, (conv, h) = ssm_mod.mamba_decode(cfg, lp["mamba"], xn,
                                              (cache_l["conv"], cache_l["ssm"]))
        cache_l["conv"].copy_(conv)
        cache_l["ssm"].copy_(h)
    else:
        mix, _ = attn.attention_decode(
            cfg, lp["attn"], xn, (cache_l["k"], cache_l["v"]), pos, window,
            static_window=uniform_static_window(cfg))
    if cfg.post_norms:
        mix = apply_norm(cfg, lp["post_norm1"], mix)
    x = x + mix
    ff = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], x))
    if cfg.post_norms:
        ff = apply_norm(cfg, lp["post_norm2"], ff)
    return x + ff, cache_l


def _decode(cfg: ModelConfig, params: Params, tokens, pos, caches: Dict):
    h = params["embed"][tokens][:, None, :] * math.sqrt(cfg.d_model)  # (B, 1, D)
    for i, (lp, win) in enumerate(_layers(cfg, params)):
        h, _ = _block_decode(cfg, lp, h, pos, {k: c[i] for k, c in caches.items()}, win)
    return compute_logits(cfg, params, h)[:, 0], caches


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, pos, caches: Dict):
    """One decode step. token (B,) ints, pos an int; returns (logits (B, V),
    caches), the caches updated in place."""
    return _decode(cfg, params, token, int(pos), caches)


def decode_step_slots(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                      pos: torch.Tensor, caches: Dict):
    """One decode step over a slot pool: every row at its own position.

    tokens (B,) ints (row b's current token), pos (B,) ints (row b's
    position; -1 = inactive slot: nothing written, logits are don't-care);
    returns (logits (B, V), caches), the caches updated in place.  This is
    the continuous-batching decode: the batch axis is the KV-cache slot pool,
    and admission or eviction change only ``tokens`` and ``pos``.
    """
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    return _decode(cfg, params, tokens, pos, caches)


def prefill(cfg: ModelConfig, params: Params, batch: Dict):
    """Process the prompt, returning last-position logits and filled caches."""
    h, caches = _prefill_hidden(cfg, params, batch)
    return compute_logits(cfg, params, h[:, -1:, :])[:, 0], caches


def prefill_at(cfg: ModelConfig, params: Params, batch: Dict, last_idx: torch.Tensor):
    """Prefill over a (possibly right-padded) prompt rectangle, returning the
    logits at per-row position ``last_idx`` (B,) — the last real prompt
    token — and the filled caches.  Causal attention keeps positions up to
    ``last_idx`` blind to the pad tail, so one bucket length serves every
    prompt that fits in it."""
    h, caches = _prefill_hidden(cfg, params, batch)
    rows = torch.arange(h.shape[0], device=h.device)
    h_last = h[rows, last_idx.to(device=h.device, dtype=torch.int64)][:, None, :]
    return compute_logits(cfg, params, h_last)[:, 0], caches


def _prefill_hidden(cfg: ModelConfig, params: Params, batch: Dict):
    """Full-sequence hidden states + per-layer caches, stacked over the
    layers: k and v (L, B, S, KV, hd), or an SSM's conv and ssm states."""
    h = embed_batch(cfg, params, batch)
    caches: Dict = {}
    for lp, win in _layers(cfg, params):
        xn = apply_norm(cfg, lp["norm1"], h)
        if cfg.arch_type == "ssm":
            mix, state = ssm_mod.mamba_prefill(cfg, lp["mamba"], xn)
            if state is None:           # the plain path: the reference's recomputation
                state = _mamba_tail_state(cfg, lp["mamba"], xn)
            layer = dict(zip(("conv", "ssm"), state))
        else:
            mix, kv = attn.attention_prefill(cfg, lp["attn"], xn, win)
            layer = dict(zip(("k", "v"), kv))
        for name, c in layer.items():
            caches.setdefault(name, []).append(c)
        if cfg.post_norms:
            mix = apply_norm(cfg, lp["post_norm1"], mix)
        h = h + mix
        ff = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], h))
        if cfg.post_norms:
            ff = apply_norm(cfg, lp["post_norm2"], ff)
        h = h + ff
    return h, {name: torch.stack(cs) for name, cs in caches.items()}


def _mamba_tail_state(cfg: ModelConfig, mp: Params, xn: torch.Tensor):
    """Recompute the post-prompt (conv, ssm) state for decode continuation,
    as the reference does: the plain associative scan over the whole
    prompt.  Only the plain path calls it; the kernel path takes the state
    from the scan kernel (``ssm.mamba_prefill``).  The conv state is the
    prompt's last ``K - 1`` rows of u, or all of them when the prompt is
    shorter; the slot write then fills only that many rows (a reference
    behaviour the port keeps: a prompt under ``K - 1`` tokens decodes from
    a misaligned conv window)."""
    u, _ = torch.chunk(xn @ mp["in_proj"], 2, dim=-1)
    K = cfg.ssm_conv
    # copies, so that no cached view keeps a layer's u or (B, S, di, n) state alive
    conv_state = u[:, -(K - 1):, :].clone()
    u_c = ssm_mod.silu(ssm_mod._causal_conv(mp, u, K))
    deltaA, deltaBu, _ = ssm_mod._ssm_inputs(cfg, mp, u_c)
    return conv_state, ssm_mod._assoc_scan(deltaA, deltaBu)[:, -1].clone()
