"""The transformer stack of ``repro.models.transformer``, every architecture.

Layer parameters are stacked on a leading ``n_layers`` axis, as the
reference's ``vmap`` init makes them, so a JAX ``init_model`` tree carries
over leaf for leaf (``repro_torch.convert``).  A Python loop over the layers
takes the place of ``lax.scan``; per-layer windows are Python ints
(``FULL_WINDOW`` = 2**30 means no window).  Caches (attention's k and v, the
SSM's conv and ssm states) are updated in place.

Every ``arch_type`` of ``configs``: dense, MoE (``models.moe`` in place of
the MLP, arctic's dense residual beside it, the load-balance aux loss summed
over the layers), SSM (mamba-1 layers, ``models.ssm``), hybrid (hymba:
attention and mamba in parallel on the same input, each RMS-normalised and
averaged), and the two frontends: vision (image embeddings put before the
text embeddings) and audio (features in place of an embedding table; an
encoder, non-causal, with no decode).  The forward pass, the training loss
(``loss_fn``: dense or vocab-chunked streaming cross-entropy, plus
``MOE_AUX_COEF`` times the aux loss), prefill and decode for serving.

Under autograd each CE vocab chunk is recomputed in the backward pass, and
with ``cfg.remat`` each layer too (``torch.utils.checkpoint``,
non-reentrant), where the reference's ``jax.checkpoint`` is: the same
values, less activation memory.  Without autograd (serving, the ZO step's
evaluations) nothing is wrapped.

Sharded placements (``dist.sharding``): with ``shards`` (a
``ShardedParams``) the parameters are this rank's shards, and the training
loss gathers each leaf on use: each layer's leaves just before the layer
runs, inside its ``checkpoint`` when ``cfg.remat`` is on (so the backward
gathers again instead of keeping the whole model alive), and the embedding,
head and final norm where they are used.  Every block, the MoE, SSM and
frontend code and every kernel call see whole tensors, as on one rank.  The
reference's placement hints for its compiler (``moe._expert_spec`` and
``_constrain``, attention's head-dim constraint) have no counterpart here.
``init_model(..., shard=)`` keeps each rank's slice of every leaf as it is
drawn (``dist.sharding.Sharder``), from the same generator in the same
order, so the shards are bit for bit slices of the replicated parameters.

Entry points that make tensors (``init_model``, ``init_caches``) run on the
card unless the caller asks for ``device="cpu"``; without a card the default
raises (``device.resolve_device``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    as_generator,
    embed_init,
    init_mlp,
    init_norm,
    rmsnorm,
    softcap,
)
from repro_torch.dist.sharding import map_with_paths
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Params = Dict
FULL_WINDOW = 1 << 30
MOE_AUX_COEF = 0.01


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's window, ``FULL_WINDOW`` for a full-attention layer."""
    return [FULL_WINDOW if w is None else int(w) for w in cfg.layer_windows()]


def windows_array(cfg: ModelConfig) -> torch.Tensor:
    return torch.tensor(layer_windows(cfg), dtype=torch.int32)


def uniform_static_window(cfg: ModelConfig) -> Optional[int]:
    """The single static window if every layer shares one, else None."""
    ws = set(cfg.layer_windows())
    if len(ws) == 1 and None not in ws:
        return int(next(iter(ws)))
    return None


def _layers(cfg: ModelConfig, params: Params) -> List[Tuple[Params, int]]:
    """(per-layer parameter views, window) for each layer, in order.

    One ``unbind`` per stacked leaf: under autograd its backward stacks the
    L layers' gradients once, where indexing each layer would zero-fill a
    gradient of the whole stacked leaf and add it, L times a backward
    pass."""
    leaves, treedef = tree_flatten(params["layers"])
    per_layer = zip(*(x.unbind(0) for x in leaves))
    return [(tree_unflatten(treedef, list(views)), w)
            for views, w in zip(per_layer, layer_windows(cfg))]


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
    if cfg.arch_type == "hybrid":
        p["attn_out_scale"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
        p["mamba_out_scale"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    if cfg.is_moe:
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
        if cfg.moe_dense_residual:
            p["dense_mlp"] = init_mlp(gen, cfg, cfg.dense_d_ff, dtype, device)
    elif cfg.d_ff:
        p["mlp"] = init_mlp(gen, cfg, cfg.d_ff, dtype, device)
    return p


def init_model(gen, cfg: ModelConfig, device="cuda", shard=None) -> Params:
    """Random parameters from ``gen`` (a ``torch.Generator`` or an int seed),
    drawn on the generator's device and placed on ``device``.  The stacked
    layer tensors are filled one layer at a time, so the largest temporary
    is one layer's matrix.  An audio model has no embedding table, and a
    head of its own.  ``shard(names, x, stack=0)`` (a
    ``dist.sharding.Sharder``) keeps this rank's part of each leaf as it is
    made; the draws are the same."""
    device = resolve_device(device)
    gen = as_generator(gen)
    dtype = getattr(torch, cfg.dtype)

    def keep(names, tree, stack=0):
        if shard is None:
            return tree
        return map_with_paths(lambda path, x: shard(names + tuple(path), x, stack), tree)

    params: Params = {}
    if cfg.frontend != "audio":
        params["embed"] = keep(("embed",), embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                                       dtype, device))
    layers = None
    for i in range(cfg.n_layers):
        lp = keep(("layers",), _init_layer(gen, cfg, dtype, device), cfg.n_layers)
        if layers is None:
            layers = tree_map(lambda x: torch.empty((cfg.n_layers, *x.shape), dtype=x.dtype,
                                                    device=x.device), lp)
        tree_map(lambda dst, x, i=i: dst[i].copy_(x), layers, lp)
    params["layers"] = layers
    params["final_norm"] = keep(("final_norm",), init_norm(cfg, cfg.d_model, device))
    if not cfg.tie_embeddings or cfg.frontend == "audio":
        params["head"] = keep(("head",), embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                                     dtype, device))
    return params


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def _ffn(cfg: ModelConfig, lp: Params, xn: torch.Tensor):
    """The feed-forward sublayer: (y, aux loss), aux 0 without experts."""
    if cfg.is_moe:
        y, aux = moe_mod.moe_forward(cfg, lp["moe"], xn)
        if cfg.moe_dense_residual:
            y = y + apply_mlp(cfg, lp["dense_mlp"], xn)
        return y, aux
    zero = torch.zeros((), dtype=torch.float32, device=xn.device)
    if cfg.d_ff:
        return apply_mlp(cfg, lp["mlp"], xn), zero
    return torch.zeros_like(xn), zero


def _fuse(cfg: ModelConfig, lp: Params, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """hymba's parallel fusion: the mean of the RMS-normalised attention and
    mamba outputs (the plain ``layers.rmsnorm``, as in the reference)."""
    return 0.5 * (rmsnorm(a, lp["attn_out_scale"], cfg.norm_eps)
                  + rmsnorm(m, lp["mamba_out_scale"], cfg.norm_eps))


def _mix(cfg: ModelConfig, lp: Params, xn: torch.Tensor, window: int) -> torch.Tensor:
    """Sequence-mixing sublayer: attention, mamba, or both (hybrid)."""
    if cfg.arch_type == "ssm":
        return ssm_mod.mamba_forward(cfg, lp["mamba"], xn)
    if cfg.arch_type == "hybrid":
        return _fuse(cfg, lp, attn.attention_forward(cfg, lp["attn"], xn, window),
                     ssm_mod.mamba_forward(cfg, lp["mamba"], xn))
    return attn.attention_forward(cfg, lp["attn"], xn, window)


def _block(cfg: ModelConfig, lp: Params, x: torch.Tensor, window: int, shards=None):
    if shards is not None:
        lp = shards.layer(lp)           # gather on use: this layer's leaves whole
    mix = _mix(cfg, lp, apply_norm(cfg, lp["norm1"], x), window)
    if cfg.post_norms:
        mix = apply_norm(cfg, lp["post_norm1"], mix)
    x = x + mix
    ff, aux = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], x))
    if cfg.post_norms:
        ff = apply_norm(cfg, lp["post_norm2"], ff)
    return x + ff, aux


# --------------------------------------------------------------------------- #
# embedding / inputs
# --------------------------------------------------------------------------- #
def _top(params: Params, name: str, shards=None):
    """A top-level entry (embed, head, final norm), gathered when sharded."""
    return params[name] if shards is None else shards.top(name, params[name])


def _head(params: Params, shards=None) -> torch.Tensor:
    return _top(params, "embed", shards).T if "head" not in params else \
        _top(params, "head", shards)


def embed_batch(cfg: ModelConfig, params: Params, batch: Dict, shards=None) -> torch.Tensor:
    """The input sequence: ``batch["features"]`` (B, S, D) for audio; else the
    scaled embeddings of ``batch["tokens"]``, after ``batch["image_embeds"]``
    (B, P, D, cast to the embeddings' dtype) for vision."""
    if cfg.frontend == "audio":
        return batch["features"]
    text = _top(params, "embed", shards)[batch["tokens"]] * math.sqrt(cfg.d_model)
    if cfg.frontend == "vision":
        return torch.cat([batch["image_embeds"].to(text.dtype), text], dim=1)
    return text


def compute_logits(cfg: ModelConfig, params: Params, h: torch.Tensor,
                   shards=None) -> torch.Tensor:
    h = apply_norm(cfg, _top(params, "final_norm", shards), h)
    logits = h @ _head(params, shards)
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def forward_hidden(cfg: ModelConfig, params: Params, h: torch.Tensor, shards=None):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp, win in _layers(cfg, params):
        if cfg.remat and torch.is_grad_enabled():
            h, a = checkpoint(_block, cfg, lp, h, win, shards, use_reentrant=False)
        else:
            h, a = _block(cfg, lp, h, win, shards)
        aux = aux + a
    return h, aux


def forward_logits(cfg: ModelConfig, params: Params, batch: Dict, shards=None):
    h = embed_batch(cfg, params, batch, shards)
    h, aux = forward_hidden(cfg, params, h, shards)
    return compute_logits(cfg, params, h, shards), aux


# --------------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------------- #
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0. logits (B,S,V), labels (B,S)."""
    mask = labels >= 0
    safe = labels.clamp(min=0).to(torch.int64)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    ce = (lse - gold) * mask
    return ce.sum() / mask.sum().clamp(min=1)


def ce_chunk_size(cfg: ModelConfig) -> int:
    """Vocab-chunk size for the streaming CE (0 = dense logits): ``cfg.ce_chunk``
    when the vocabulary is larger, 0 when it is negative, else 8192 from a
    vocabulary of 16384 up (the live logits are B*S*chunk, not B*S*V)."""
    if cfg.ce_chunk > 0:
        return cfg.ce_chunk if cfg.vocab_size > cfg.ce_chunk else 0
    if cfg.ce_chunk < 0 or cfg.vocab_size < 16384:
        return 0
    return 8192


def _ce_chunk(cfg: ModelConfig, c_idx: int, chunk: int, m, s, gold, hf, head, safe):
    """One vocab chunk of the streaming CE: the running (max, sum of exp,
    gold logit) carry updated with columns ``[start, start + chunk)``."""
    V = head.shape[1]
    start = max(min(c_idx * chunk, V - chunk), 0)
    logits = (hf @ head[:, start:start + chunk]).to(torch.float32)     # (T, chunk)
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    col = start + torch.arange(chunk, dtype=torch.int64, device=hf.device)
    fresh = col >= c_idx * chunk                        # mask the overlap columns
    logits = torch.where(fresh[None, :], logits, torch.full_like(logits, -1e30))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
    rel = safe - start
    in_r = (rel >= 0) & (rel < chunk) & (safe >= c_idx * chunk)
    got = torch.gather(logits, 1, rel.clamp(0, chunk - 1)[:, None])[:, 0]
    gold = gold + torch.where(in_r, got, torch.zeros_like(got))
    return m_new, s, gold


def cross_entropy_streaming(cfg: ModelConfig, head: torch.Tensor, h: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """CE with vocab-chunked logits: a loop over (D, chunk) head slices with
    a running (max, sumexp, gold) carry.  The last slice's start clamps to
    ``V - chunk``, so it may overlap the one before; the columns already
    counted are masked to -1e30.  Under autograd each chunk's logits are
    recomputed in the backward pass instead of stored."""
    chunk = ce_chunk_size(cfg)
    B, S, D = h.shape
    V = head.shape[1]
    if not chunk or V <= chunk:
        return cross_entropy(h @ head, labels)
    T = B * S
    hf = h.reshape(T, D)
    lab = labels.reshape(T)
    mask = lab >= 0
    safe = lab.clamp(min=0).to(torch.int64)
    n_chunks = (V + chunk - 1) // chunk
    carry = (torch.full((T,), -1e30, dtype=torch.float32, device=h.device),
             torch.zeros((T,), dtype=torch.float32, device=h.device),
             torch.zeros((T,), dtype=torch.float32, device=h.device))
    for c_idx in range(n_chunks):
        if torch.is_grad_enabled():
            carry = checkpoint(_ce_chunk, cfg, c_idx, chunk, *carry, hf, head, safe,
                               use_reentrant=False)
        else:
            carry = _ce_chunk(cfg, c_idx, chunk, *carry, hf, head, safe)
    m, s, gold = carry
    ce = (m + torch.log(s) - gold) * mask
    return ce.sum() / mask.sum().clamp(min=1)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict, shards=None) -> torch.Tensor:
    """Mean next-token CE over ``batch["labels"] >= 0`` plus ``MOE_AUX_COEF``
    times the layers' summed MoE aux loss (0 without experts); ``batch``
    holds ``labels`` (B, S) ints and the inputs ``embed_batch`` reads.  With
    ``shards`` the parameters are this rank's shards, gathered on use (the
    module docstring)."""
    h = embed_batch(cfg, params, batch, shards)
    h, aux = forward_hidden(cfg, params, h, shards)
    if ce_chunk_size(cfg):
        h = apply_norm(cfg, _top(params, "final_norm", shards), h)
        ce = cross_entropy_streaming(cfg, _head(params, shards), h, batch["labels"])
    else:
        ce = cross_entropy(compute_logits(cfg, params, h, shards), batch["labels"])
    return ce + MOE_AUX_COEF * aux


# --------------------------------------------------------------------------- #
# serving: prefill + single-token decode with stacked per-layer caches
# --------------------------------------------------------------------------- #
def init_caches(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                device="cuda") -> Dict:
    """Zero caches, stacked over the layers: attention's k and v ``(L,
    batch, seq_len, KV, hd)``; an SSM's conv state ``(L, batch, K - 1,
    d_inner)`` in ``dtype`` and ssm state ``(L, batch, d_inner, n)`` in
    float32 (no sequence axis: ``seq_len`` does not size them); a hybrid
    model holds all four."""
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
    """One layer of decode; writes this layer's cache rows (attention) and
    states (SSM: every row, an inactive slot's too, as in the reference) in
    place.  A hybrid layer reads its own window (hymba's differ by layer)."""
    xn = apply_norm(cfg, lp["norm1"], x)
    if cfg.has_attention:
        a, _ = attn.attention_decode(
            cfg, lp["attn"], xn, (cache_l["k"], cache_l["v"]), pos, window,
            static_window=uniform_static_window(cfg))
    if cfg.has_ssm:
        m, (conv, h) = ssm_mod.mamba_decode(cfg, lp["mamba"], xn,
                                            (cache_l["conv"], cache_l["ssm"]))
        cache_l["conv"].copy_(conv)
        cache_l["ssm"].copy_(h)
    mix = (_fuse(cfg, lp, a, m) if cfg.arch_type == "hybrid" else
           m if cfg.has_ssm else a)
    if cfg.post_norms:
        mix = apply_norm(cfg, lp["post_norm1"], mix)
    x = x + mix
    ff, _ = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], x))
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
    layers: k and v (L, B, S, KV, hd), an SSM's conv and ssm states, or a
    hybrid's four."""
    h = embed_batch(cfg, params, batch)
    caches: Dict = {}
    for lp, win in _layers(cfg, params):
        xn = apply_norm(cfg, lp["norm1"], h)
        layer: Dict = {}
        if cfg.has_attention:
            a, (layer["k"], layer["v"]) = attn.attention_prefill(cfg, lp["attn"], xn, win)
        if cfg.has_ssm:
            m, state = ssm_mod.mamba_prefill(cfg, lp["mamba"], xn)
            if state is None:           # the plain path: the reference's recomputation
                state = _mamba_tail_state(cfg, lp["mamba"], xn)
            layer["conv"], layer["ssm"] = state
        mix = (_fuse(cfg, lp, a, m) if cfg.arch_type == "hybrid" else
               m if cfg.has_ssm else a)
        for name, c in layer.items():
            caches.setdefault(name, []).append(c)
        if cfg.post_norms:
            mix = apply_norm(cfg, lp["post_norm1"], mix)
        h = h + mix
        ff, _ = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], h))
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
