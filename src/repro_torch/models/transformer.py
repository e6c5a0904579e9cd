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
``ShardedParams``) the parameters are this rank's shards and the training
loss runs the partitioned forward of Megatron's convention over the
``model`` axis, as the reference's compiler partitions its products under
its placements (``attention._constrain_hd``, ``moe._constrain``).  Each
layer's leaves are gathered over the storage axes only (``data`` under
fsdp) just before the layer runs, inside its ``checkpoint`` when
``cfg.remat`` is on; attention runs this rank's heads (every head, on
the gathered q, k and v products, where the axis cuts inside a head:
``models.attention``), the MLP and the
experts its columns of the hidden dim (or, ``moe_sharding='expert'``, its
experts), each sublayer summed by one rank-ordered all-reduce of float32
partials; the mamba mixer its channels of ``d_inner`` (``models.ssm``:
``in_proj`` kept cut, the pieces of u and z a rank needs exchanged;
``x_proj`` and ``out_proj`` row-parallel, an all-reduce each); the embedding is a
vocab-parallel lookup, the head and the cross-entropy vocab-parallel (each
rank its columns, the carries combined over the axis).  The loss is the
same scalar on every rank.  ``init_model(..., shard=)``
keeps each rank's slice of every leaf as it is drawn
(``dist.sharding.Sharder``), from the same generator in the same order, so
the shards are bit for bit slices of the replicated parameters.

Serving runs the same partition (``prefill``, ``prefill_at``,
``decode_step``, ``decode_step_slots`` with ``shards``): each rank holds its
slices of the caches (``init_caches(..., shards=)``, the cut of
``dist.sharding.cache_specs`` over ``model``), the decode's embedding is
the vocab-parallel lookup, and the logits of a head cut over ``model`` are
gathered over the axis before they are returned, so every rank samples
from the same bits.  ``decode_step`` also runs on caches whose sequence the
worker axes cut (``ShardedParams(..., seq_sharded=True)``, ``long_500k``):
each rank reads its rows of the window and the ranks' partial softmaxes
are combined (``attention.attention_decode``); SSM states are whole on
every rank of those axes.

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
    mlp_partial,
    rmsnorm,
    softcap,
)
from repro_torch.dist.sharding import cache_slices, map_with_paths
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
def _axes(shards):
    """``name -> the model axis`` when it cuts a leaf of the layer's
    sublayer ``name`` (a ``dist.sharding.ModelAxis``), else None."""
    return (lambda name: None) if shards is None else (lambda name: shards.axis_for((name,)))


def _ffn(cfg: ModelConfig, lp: Params, xn: torch.Tensor, shards=None):
    """The feed-forward sublayer: (y, aux loss), aux 0 without experts.  With
    ``shards`` a sublayer the ``model`` axis cuts runs partitioned; the
    experts' and arctic's dense residual's partials share one all-reduce."""
    axis = _axes(shards)
    if cfg.is_moe:
        tp = axis("moe")
        dense = axis("dense_mlp") if cfg.moe_dense_residual else None
        if tp is None:
            y, aux = moe_mod.moe_forward(cfg, lp["moe"], xn)
        else:
            x_in = tp.enter(xn)
            part, aux = moe_mod.moe_partial(cfg, lp["moe"], xn, x_in, tp)
            if dense is not None:
                part = part + mlp_partial(cfg, lp["dense_mlp"], x_in)
            y = tp.reduce(part, xn.dtype)
        if cfg.moe_dense_residual and (tp is None or dense is None):
            y = y + apply_mlp(cfg, lp["dense_mlp"], xn, dense)
        return y, aux
    zero = torch.zeros((), dtype=torch.float32, device=xn.device)
    if cfg.d_ff:
        return apply_mlp(cfg, lp["mlp"], xn, axis("mlp")), zero
    return torch.zeros_like(xn), zero


def _fuse(cfg: ModelConfig, lp: Params, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """hymba's parallel fusion: the mean of the RMS-normalised attention and
    mamba outputs (the plain ``layers.rmsnorm``, as in the reference)."""
    return 0.5 * (rmsnorm(a, lp["attn_out_scale"], cfg.norm_eps)
                  + rmsnorm(m, lp["mamba_out_scale"], cfg.norm_eps))


def _mix(cfg: ModelConfig, lp: Params, xn: torch.Tensor, window: int,
         shards=None) -> torch.Tensor:
    """Sequence-mixing sublayer: attention, mamba, or both (hybrid); with
    ``shards`` each partitioned over ``model`` where the axis cuts it."""
    axis = _axes(shards)
    if cfg.arch_type == "ssm":
        return ssm_mod.mamba_forward(cfg, lp["mamba"], xn, axis("mamba"))
    a = attn.attention_forward(cfg, lp["attn"], xn, window, axis("attn"))
    if cfg.arch_type == "hybrid":
        return _fuse(cfg, lp, a, ssm_mod.mamba_forward(cfg, lp["mamba"], xn, axis("mamba")))
    return a


def _block(cfg: ModelConfig, lp: Params, x: torch.Tensor, window: int, shards=None):
    if shards is not None:
        lp = shards.layer(lp)           # the storage axes gathered, the model cut kept
    mix = _mix(cfg, lp, apply_norm(cfg, lp["norm1"], x), window, shards)
    if cfg.post_norms:
        mix = apply_norm(cfg, lp["post_norm1"], mix)
    x = x + mix
    ff, aux = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], x), shards)
    if cfg.post_norms:
        ff = apply_norm(cfg, lp["post_norm2"], ff)
    return x + ff, aux


# --------------------------------------------------------------------------- #
# embedding / inputs
# --------------------------------------------------------------------------- #
def _top(params: Params, name: str, shards=None):
    """A top-level entry (embed, head, final norm), its storage axes
    gathered when sharded."""
    return params[name] if shards is None else shards.top(name, params[name])


def _head(params: Params, shards=None):
    """``(head (D, V) or this rank's vocabulary columns, the model axis when
    it cuts them)``: the tied ``embed.T`` when there is no head."""
    name = "head" if "head" in params else "embed"
    w = _top(params, name, shards)
    tp = None if shards is None else shards.axis_for((name,), top=True)
    return (w if name == "head" else w.T), tp


def _embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  shards=None) -> torch.Tensor:
    """The scaled embeddings of ``tokens``.  A table cut over ``model`` is a
    vocab-parallel lookup: each rank its rows, the ids outside them zero,
    summed over the axis (one term per id, so the sum is exact)."""
    table = _top(params, "embed", shards)
    tp = None if shards is None else shards.axis_for(("embed",), top=True)
    if tp is None:
        text = table[tokens]
    else:
        n = table.shape[0]
        local = tokens.to(torch.int64) - tp.rank * n
        mine = ((local >= 0) & (local < n))[..., None]
        rows = table[local.clamp(0, n - 1)]
        text = tp.reduce(torch.where(mine, rows, torch.zeros_like(rows)), rows.dtype)
    return text * math.sqrt(cfg.d_model)


def embed_batch(cfg: ModelConfig, params: Params, batch: Dict, shards=None) -> torch.Tensor:
    """The input sequence: ``batch["features"]`` (B, S, D) for audio; else the
    scaled embeddings of ``batch["tokens"]`` (``_embed_tokens``), after
    ``batch["image_embeds"]`` (B, P, D, cast to the embeddings' dtype) for
    vision."""
    if cfg.frontend == "audio":
        return batch["features"]
    text = _embed_tokens(cfg, params, batch["tokens"], shards)
    if cfg.frontend == "vision":
        return torch.cat([batch["image_embeds"].to(text.dtype), text], dim=1)
    return text


def compute_logits(cfg: ModelConfig, params: Params, h: torch.Tensor,
                   shards=None) -> torch.Tensor:
    """The logits of the hidden states ``h``.  A head cut over ``model``
    gives each rank its vocabulary columns; they are gathered over the axis
    in rank order (whole rows, the same bits on every rank)."""
    h = apply_norm(cfg, _top(params, "final_norm", shards), h)
    head, tp = _head(params, shards)
    logits = h @ head
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits if tp is None else tp.cat(logits, -1, label="logits")


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
    gold logit) carry updated with columns ``[start, start + chunk)`` of
    ``head``'s V (a rank's own columns under a vocab-parallel head, ``safe``
    the labels relative to its first column)."""
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


def _ce_carry(cfg: ModelConfig, chunk: int, hf: torch.Tensor, head: torch.Tensor,
              safe: torch.Tensor):
    """The (max, sum of exp, gold logit) carry over every column of
    ``head``, chunk by chunk; under autograd each chunk's logits are
    recomputed in the backward pass instead of stored."""
    T = hf.shape[0]
    n_chunks = (head.shape[1] + chunk - 1) // chunk
    carry = (torch.full((T,), -1e30, dtype=torch.float32, device=hf.device),
             torch.zeros((T,), dtype=torch.float32, device=hf.device),
             torch.zeros((T,), dtype=torch.float32, device=hf.device))
    for c_idx in range(n_chunks):
        if torch.is_grad_enabled():
            carry = checkpoint(_ce_chunk, cfg, c_idx, chunk, *carry, hf, head, safe,
                               use_reentrant=False)
        else:
            carry = _ce_chunk(cfg, c_idx, chunk, *carry, hf, head, safe)
    return carry


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
    lab = labels.reshape(B * S)
    mask = lab >= 0
    m, s, gold = _ce_carry(cfg, chunk, h.reshape(B * S, D), head,
                           lab.clamp(min=0).to(torch.int64))
    ce = (m + torch.log(s) - gold) * mask
    return ce.sum() / mask.sum().clamp(min=1)


def cross_entropy_vocab_parallel(cfg: ModelConfig, head: torch.Tensor, h: torch.Tensor,
                                 labels: torch.Tensor, tp) -> torch.Tensor:
    """The CE of a head whose vocabulary columns the ``model`` axis cuts:
    ``head`` is this rank's ``V/ms`` columns, ``h`` the normed hidden state
    after ``tp.enter``.  Each rank runs its columns to a local (max, sum of
    exp, gold logit) carry, streamed in ``ce_chunk_size`` chunks when its
    columns are more than a chunk (the last chunk's clamp and overlap mask
    within its own columns), else dense with the dense path's softcap; the
    carries are combined over the axis in rank order with the global max M:
    ``M + log(sum s·exp(m - M)) - sum gold``, the same scalar on every rank."""
    B, S, D = h.shape
    hf = h.reshape(B * S, D)
    lab = labels.reshape(B * S)
    mask = lab >= 0
    n = head.shape[1]
    local = lab.clamp(min=0).to(torch.int64) - tp.rank * n
    chunk = ce_chunk_size(cfg)
    if chunk and n > chunk:
        m, s, gold = _ce_carry(cfg, chunk, hf, head, local)
    else:
        logits = hf @ head
        if cfg.final_softcap:
            logits = softcap(logits, cfg.final_softcap)
        lf = logits.to(torch.float32)
        m = lf.amax(dim=-1)
        s = torch.exp(lf - m[:, None]).sum(-1)
        got = torch.gather(lf, 1, local.clamp(0, n - 1)[:, None])[:, 0]
        gold = torch.where((local >= 0) & (local < n), got, torch.zeros_like(got))
    parts = tp.parts(torch.stack([m, s, gold]))                 # (ms, 3, T)
    big = parts[:, 0].amax(dim=0)
    total, gold = parts[0, 1] * torch.exp(parts[0, 0] - big), parts[0, 2]
    for r in range(1, parts.shape[0]):
        total = total + parts[r, 1] * torch.exp(parts[r, 0] - big)
        gold = gold + parts[r, 2]
    ce = (big + torch.log(total) - gold) * mask
    return ce.sum() / mask.sum().clamp(min=1)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict, shards=None) -> torch.Tensor:
    """Mean next-token CE over ``batch["labels"] >= 0`` plus ``MOE_AUX_COEF``
    times the layers' summed MoE aux loss (0 without experts); ``batch``
    holds ``labels`` (B, S) ints and the inputs ``embed_batch`` reads.  With
    ``shards`` the parameters are this rank's shards and the forward is
    partitioned over the ``model`` axis (the module docstring)."""
    h = embed_batch(cfg, params, batch, shards)
    h, aux = forward_hidden(cfg, params, h, shards)
    h = apply_norm(cfg, _top(params, "final_norm", shards), h)
    head, tp = _head(params, shards)
    if tp is not None:
        ce = cross_entropy_vocab_parallel(cfg, head, tp.enter(h), batch["labels"], tp)
    elif ce_chunk_size(cfg):
        ce = cross_entropy_streaming(cfg, head, h, batch["labels"])
    else:
        logits = h @ head
        if cfg.final_softcap:
            logits = softcap(logits, cfg.final_softcap)
        ce = cross_entropy(logits, batch["labels"])
    return ce + MOE_AUX_COEF * aux


# --------------------------------------------------------------------------- #
# serving: prefill + single-token decode with stacked per-layer caches
# --------------------------------------------------------------------------- #
def init_caches(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                device="cuda", shards=None) -> Dict:
    """Zero caches, stacked over the layers: attention's k and v ``(L,
    batch, seq_len, KV, hd)``; an SSM's conv state ``(L, batch, K - 1,
    d_inner)`` in ``dtype`` and ssm state ``(L, batch, d_inner, n)`` in
    float32 (no sequence axis: ``seq_len`` does not size them); a hybrid
    model holds all four.  With ``shards`` each is this rank's slice
    (``dist.sharding.cache_slices``: k and v cut over KV heads, or over
    ``hd`` when KV does not divide the axis; conv and ssm over
    ``d_inner``), allocated at that size; a sequence-sharded ``shards``
    (``shards.seq``) also cuts k's and v's ``seq_len`` rows over the worker
    axes, the rank holding its rows ``shards.seq.rows(seq_len)``."""
    device = resolve_device(device)
    L = cfg.n_layers
    shapes: Dict = {}
    if cfg.has_attention:
        shapes["k"] = shapes["v"] = ((L, batch, seq_len, cfg.n_kv_heads, cfg.head_dim), dtype)
    if cfg.has_ssm:
        shapes["conv"] = ((L, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype)
        shapes["ssm"] = ((L, batch, cfg.d_inner, cfg.ssm_state), torch.float32)
    if shards is not None:
        cut = cache_slices(cfg, shards.mesh, {name: torch.empty(shape, device="meta")
                                              for name, (shape, _) in shapes.items()},
                           seq_sharded=shards.seq is not None)
        shapes = {name: (tuple(sl.stop - sl.start for sl in cut[name]), dt)
                  for name, (_, dt) in shapes.items()}
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in shapes.items()}


def _block_decode(cfg: ModelConfig, lp: Params, x, pos, cache_l: Dict, window: int,
                  shards=None):
    """One layer of decode; writes this layer's cache rows (attention) and
    states (SSM: every row, an inactive slot's too, as in the reference) in
    place.  A hybrid layer reads its own window (hymba's differ by layer).
    With ``shards`` the layer runs partitioned and ``cache_l`` is this
    rank's slice (of the sequence too, with ``shards.seq``)."""
    axis = _axes(shards)
    if shards is not None:
        lp = shards.layer(lp)
    xn = apply_norm(cfg, lp["norm1"], x)
    if cfg.has_attention:
        a, _ = attn.attention_decode(
            cfg, lp["attn"], xn, (cache_l["k"], cache_l["v"]), pos, window,
            static_window=uniform_static_window(cfg), tp=axis("attn"),
            seq=None if shards is None else shards.seq)
    if cfg.has_ssm:
        m, (conv, h) = ssm_mod.mamba_decode(cfg, lp["mamba"], xn,
                                            (cache_l["conv"], cache_l["ssm"]), axis("mamba"))
        cache_l["conv"].copy_(conv)
        cache_l["ssm"].copy_(h)
    mix = (_fuse(cfg, lp, a, m) if cfg.arch_type == "hybrid" else
           m if cfg.has_ssm else a)
    if cfg.post_norms:
        mix = apply_norm(cfg, lp["post_norm1"], mix)
    x = x + mix
    ff, _ = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], x), shards)
    if cfg.post_norms:
        ff = apply_norm(cfg, lp["post_norm2"], ff)
    return x + ff, cache_l


def _decode(cfg: ModelConfig, params: Params, tokens, pos, caches: Dict, shards=None):
    h = _embed_tokens(cfg, params, tokens[:, None], shards)          # (B, 1, D)
    for i, (lp, win) in enumerate(_layers(cfg, params)):
        h, _ = _block_decode(cfg, lp, h, pos, {k: c[i] for k, c in caches.items()}, win,
                             shards)
    return compute_logits(cfg, params, h, shards)[:, 0], caches


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, pos, caches: Dict,
                shards=None):
    """One decode step. token (B,) ints, pos an int; returns (logits (B, V),
    caches), the caches updated in place.  With ``shards`` this rank's
    shards and cache slices; a sequence-sharded ``shards`` (``long_500k``)
    combines each attention layer's partial softmaxes over the worker
    axes, and the logits are the same bits on every rank."""
    return _decode(cfg, params, token, int(pos), caches, shards)


def decode_step_slots(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                      pos: torch.Tensor, caches: Dict, shards=None):
    """One decode step over a slot pool: every row at its own position.

    tokens (B,) ints (row b's current token), pos (B,) ints (row b's
    position; -1 = inactive slot: nothing written, logits are don't-care);
    returns (logits (B, V), caches), the caches updated in place.  This is
    the continuous-batching decode: the batch axis is the KV-cache slot pool,
    and admission or eviction change only ``tokens`` and ``pos``.  With
    ``shards`` the step runs partitioned over ``model`` on this rank's
    shards and its slices of the caches (``init_caches(..., shards)``); the
    logits are whole on every rank.
    """
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    return _decode(cfg, params, tokens, pos, caches, shards)


def prefill(cfg: ModelConfig, params: Params, batch: Dict, shards=None):
    """Process the prompt, returning last-position logits and filled caches
    (with ``shards``: this rank's slices)."""
    h, caches = _prefill_hidden(cfg, params, batch, shards)
    return compute_logits(cfg, params, h[:, -1:, :], shards)[:, 0], caches


def prefill_at(cfg: ModelConfig, params: Params, batch: Dict, last_idx: torch.Tensor,
               shards=None):
    """Prefill over a (possibly right-padded) prompt rectangle, returning the
    logits at per-row position ``last_idx`` (B,) — the last real prompt
    token — and the filled caches.  Causal attention keeps positions up to
    ``last_idx`` blind to the pad tail, so one bucket length serves every
    prompt that fits in it."""
    h, caches = _prefill_hidden(cfg, params, batch, shards)
    rows = torch.arange(h.shape[0], device=h.device)
    h_last = h[rows, last_idx.to(device=h.device, dtype=torch.int64)][:, None, :]
    return compute_logits(cfg, params, h_last, shards)[:, 0], caches


def _prefill_hidden(cfg: ModelConfig, params: Params, batch: Dict, shards=None):
    """Full-sequence hidden states + per-layer caches, stacked over the
    layers: k and v (L, B, S, KV, hd), an SSM's conv and ssm states, or a
    hybrid's four; with ``shards`` the layers partitioned over ``model`` and
    the caches this rank's slices."""
    axis = _axes(shards)
    h = embed_batch(cfg, params, batch, shards)
    caches: Dict = {}
    for lp, win in _layers(cfg, params):
        if shards is not None:
            lp = shards.layer(lp)
        xn = apply_norm(cfg, lp["norm1"], h)
        layer: Dict = {}
        if cfg.has_attention:
            a, (layer["k"], layer["v"]) = attn.attention_prefill(cfg, lp["attn"], xn, win,
                                                                 axis("attn"))
        if cfg.has_ssm:
            m, state = ssm_mod.mamba_prefill(cfg, lp["mamba"], xn, axis("mamba"))
            if state is None:           # the plain path: the reference's recomputation
                state = _mamba_tail_state(cfg, lp["mamba"], xn, axis("mamba"))
            layer["conv"], layer["ssm"] = state
        mix = (_fuse(cfg, lp, a, m) if cfg.arch_type == "hybrid" else
               m if cfg.has_ssm else a)
        for name, c in layer.items():
            caches.setdefault(name, []).append(c)
        if cfg.post_norms:
            mix = apply_norm(cfg, lp["post_norm1"], mix)
        h = h + mix
        ff, _ = _ffn(cfg, lp, apply_norm(cfg, lp["norm2"], h), shards)
        if cfg.post_norms:
            ff = apply_norm(cfg, lp["post_norm2"], ff)
        h = h + ff
    return h, {name: torch.stack(cs) for name, cs in caches.items()}


def _mamba_tail_state(cfg: ModelConfig, mp: Params, xn: torch.Tensor, tp=None):
    """Recompute the post-prompt (conv, ssm) state for decode continuation,
    as the reference does: the plain associative scan over the whole
    prompt.  Only the plain path calls it; the kernel path takes the state
    from the scan kernel (``ssm.mamba_prefill``).  The conv state is the
    prompt's last ``K - 1`` rows of u, or all of them when the prompt is
    shorter; the slot write then fills only that many rows (a reference
    behaviour the port keeps: a prompt under ``K - 1`` tokens decodes from
    a misaligned conv window).  With ``tp`` the state of this rank's
    channels (its u exchanged alone, ``ssm._rank_uz``; ``ssm._rank_channels``,
    ``x_proj`` summed over the axis)."""
    if tp is None:
        u, _ = torch.chunk(xn @ mp["in_proj"], 2, dim=-1)
    else:
        (u,) = ssm_mod._rank_uz(cfg, mp, tp.enter(xn), tp, "u")
        mp = ssm_mod._rank_channels(cfg, mp, tp)
    K = cfg.ssm_conv
    # copies, so that no cached view keeps a layer's u or (B, S, di, n) state alive
    conv_state = u[:, -(K - 1):, :].clone()
    u_c = ssm_mod.silu(ssm_mod._causal_conv(mp, u, K))
    deltaA, deltaBu, _ = ssm_mod._ssm_inputs(cfg, mp, u_c, tp)
    return conv_state, ssm_mod._assoc_scan(deltaA, deltaBu)[:, -1].clone()
