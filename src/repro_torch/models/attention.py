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
updated cache is returned as well.

Partitioned over the ``model`` axis (``attention_forward(..., tp=)``, the
training loss on sharded placements; ``_RankProjection``), ``wo`` is
row-parallel: a rank's rows take its columns of the attention output, and
one rank-ordered all-reduce of float32 partials sums them.  On whole heads
(``H`` and ``KV`` divisible by the axis) a rank runs its ``H/ms`` query
heads and ``KV/ms`` KV heads, its own columns of ``wq``, ``wk`` and
``wv``, contiguous as ``shard_slices`` cuts them, and the GQA grouping
``h // (H/KV)`` holds within them (a replicated ``wk``/``wv`` enters, and
the rank takes the KV heads its queries read).  Where the axis cuts
``wq``, ``wk`` or ``wv`` inside a head (``KV % ms``: the divisibility
guard cuts ``KV·hd``; ``H % ms`` likewise cuts ``wq``), no weight crosses
ranks: as the reference's compiler does under its placements, each rank
computes its columns of the q, k and v products, which are gathered over
the axis (``B·S·H·hd`` and twice ``B·S·KV·hd`` elements, label ``qkv``),
normed and rotated on whole heads, and every rank attends with every
head (the flash kernel's usual route); ``ModelAxis.split`` then takes the
rank's columns of the output for its rows of ``wo``.  In the backward
``split`` gathers the output's gradient (label ``attn_out_grad``), every
rank computes the same attention backward, ``cat`` hands each rank its
slice of the products' gradients, and one all-reduce (``enter``) sums
x's.  ``q_norm``, ``k_norm``, rope and the softcap act per head.

Serving on sharded placements (``attention_prefill``/``attention_decode``
with ``tp``) runs the same projection, and the rank's k/v cache is its
slice of ``dist.sharding.cache_specs`` (``cache_cut``): its own KV heads
when ``KV`` divides the axis, else a slice of ``hd`` of every KV head.  In
the second case the prefill stores the ``hd`` slice of the whole heads'
k and v (no collective beyond the products'), and a decode step keeps the
cache cut, as the reference's ``_constrain_hd`` pins it (``_hd_decode``):
q, k and v of every head, cut to the rank's ``hd`` slice; each rank
contracts its slice (every query head against its KV head's slice of the
cache), the float32 partial logits are summed over the axis in rank order
(``partial_logits``), and only then scaled by ``sqrt(hd)`` of the whole
head, soft-capped and masked; every rank takes the same softmax, weighs
its ``hd`` slice of v, and the ``(B, 1, H, hd/ms)`` outputs are gathered
over ``hd`` (``attn_out``) before the rank's rows of ``wo``.  No cache
crosses ranks.

A sequence-sharded cache (``long_500k``: ``dist.sharding.SequenceAxis``)
holds a rank's rows of the sequence; a scalar-position decode on it reads
the rank's rows of the window, and the ranks' partial softmaxes are
combined over the worker axes (``_decode_seq_sharded``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import cache_slices, row_partial
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
    """q (B, S, heads, hd), k and v (B, S, kv heads, hd), the heads those of
    ``p``'s columns."""
    return _qkv_heads(cfg, p, x @ p["wq"], x @ p["wk"], x @ p["wv"], positions)


def _qkv_heads(cfg: ModelConfig, p: Params, q, k, v, positions: torch.Tensor):
    """The products q, k and v (B, S, heads·hd) as heads, normed and
    rotated (``p``'s ``q_norm``/``k_norm``)."""
    B, S, _ = q.shape
    hd = cfg.head_dim
    q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.encoder_only:
        return q, k, v
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _logits(cfg: ModelConfig, q, k, q_positions, k_positions, window, causal,
            hd_axis=None) -> torch.Tensor:
    """The masked float32 logits ``(B, KV, H/KV, Sq, Sk)`` of ``_attend``.
    With ``hd_axis`` (a ``ModelAxis``) q and k are this rank's slice of
    ``hd``: the partial products are summed over the axis before the scale
    by the whole head's ``sqrt(hd)``, the softcap and the masks."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(torch.float32), k.to(torch.float32))
    if hd_axis is not None:
        logits = hd_axis.sum(logits, label="partial_logits")
        hd *= hd_axis.size
    logits = logits / math.sqrt(hd)
    if cfg.attn_softcap:
        logits = softcap(logits, cfg.attn_softcap)
    return _masked(logits, q_positions, k_positions, window, causal)


def _masked(logits, q_positions, k_positions, window, causal) -> torch.Tensor:
    """``(B, KV, H/KV, Sq, Sk)`` logits with the causal and window masks'
    blanks at -1e30."""
    B, Sq, Sk = logits.shape[0], logits.shape[-2], logits.shape[-1]
    qp = q_positions.reshape(-1, Sq).expand(B, Sq)
    kp = k_positions.reshape(-1, Sk).expand(B, Sk)
    rel = qp[:, :, None] - kp[:, None, :]                # (B, Sq, Sk)
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    return torch.where(mask[:, None, None], logits, torch.full_like(logits, -1e30))


def _attend(
    cfg: ModelConfig,
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Sk, KV, hd)
    v: torch.Tensor,              # (B, Sk, KV, hd)
    q_positions: torch.Tensor,    # (B, Sq) or (Sq,)
    k_positions: torch.Tensor,    # (B, Sk) or (Sk,)
    window: Optional[int],        # None = full attention
    causal: bool,
    hd_axis=None,                 # q, k, v this rank's slice of hd (_hd_decode)
) -> torch.Tensor:
    B, Sq = q.shape[:2]
    logits = _logits(cfg, q, k, q_positions, k_positions, window, causal, hd_axis)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.to(torch.float32))
    if hd_axis is not None:
        out = hd_axis.cat(out, -1, label="attn_out")
    return out.reshape(B, Sq, -1).to(q.dtype)


def _attend_partial(cfg: ModelConfig, q, k, v, q_positions, k_positions, window,
                    hd_axis=None) -> torch.Tensor:
    """``_attend``'s causal softmax over the keys given, left unnormalised,
    for a combine over ranks that each hold a part of the keys
    (``_combine_partials``): ``(B, Sq, KV, H/KV, hd + 2)`` float32, the last
    dim the output ``o = sum exp(logit - m) v``, the row max ``m`` of the
    masked logits and ``l = sum exp(logit - m)``, with the softcap and masks
    of ``_attend`` (``hd``: q's, this rank's slice with ``hd_axis``).  No
    keys (a rank whose rows miss the window) give ``m = -1e30``, ``l = 0``
    and ``o = 0``."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[1] == 0:
        out = torch.zeros((B, Sq, KV, H // KV, hd + 2), dtype=torch.float32, device=q.device)
        out[..., hd] = -1e30
        return out
    logits = _logits(cfg, q, k, q_positions, k_positions, window, True, hd_axis)
    m = logits.amax(dim=-1)                                  # (B, KV, G, Sq)
    e = torch.exp(logits - m[..., None])
    o = torch.einsum("bgrqk,bkgd->bqgrd", e, v.to(torch.float32))
    ml = torch.stack([m, e.sum(dim=-1)], dim=-1).permute(0, 3, 1, 2, 4)
    return torch.cat([o, ml], dim=-1)


def _combine_partials(parts: torch.Tensor, hd: int) -> torch.Tensor:
    """The attention output ``(B, Sq, KV, H/KV, hd)`` from every rank's
    ``_attend_partial`` stacked in rank order: ``m = max m_r``, ``l = sum
    l_r exp(m_r - m)``, ``o = sum o_r exp(m_r - m) / l``, summed in rank
    order, so every rank computes the same bits."""
    m_r, l_r, o_r = parts[..., hd], parts[..., hd + 1], parts[..., :hd]
    m = m_r.amax(dim=0)
    l = o = None
    for r in range(parts.shape[0]):
        w = torch.exp(m_r[r] - m)
        l = l_r[r] * w if l is None else l + l_r[r] * w
        o = o_r[r] * w[..., None] if o is None else o + o_r[r] * w[..., None]
    return o / l[..., None]


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
                      window: Optional[int] = None, tp=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill), causal unless encoder_only;
    with ``tp`` (a ``dist.sharding.ModelAxis``) partitioned over it (the
    module docstring)."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    if tp is not None:
        r = _RankProjection(cfg, p, x, positions, tp)
        return r.out(_attend_seq(cfg, r.q, r.attended(r.k), r.attended(r.v), positions, window))
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _attend_seq(cfg, q, k, v, positions, window) @ p["wo"]


def _inside_a_head(cfg: ModelConfig, p: Params) -> bool:
    """Whether the ``model`` axis cuts ``wq``, ``wk`` or ``wv`` inside a head
    (``p`` this rank's shards: a cut on head boundaries leaves whole
    heads a rank)."""
    return any(p[n].shape[-1] % cfg.head_dim for n in ("wq", "wk", "wv"))


def _rank_heads(cfg: ModelConfig, p: Params, tp) -> Tuple[Params, int, int]:
    """On whole heads: ``(this rank's q/k/v weights and norms, its query
    heads' first column, the first KV head of its wk/wv)``.  Its query heads
    are its own columns of ``wq``, those that its rows of ``wo`` take; its
    KV heads its own columns of ``wk``/``wv``, or every KV head where they
    are replicated (``KV·hd`` does not divide the axis), entered."""
    hd, group = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    c0 = tp.rank * p["wo"].shape[0]
    local = {n: p[n] for n in ("wq", "wk", "wv")}
    k0 = c0 // hd // group
    if p["wk"].shape[-1] == cfg.n_kv_heads * hd:
        local.update(wk=tp.enter(p["wk"]), wv=tp.enter(p["wv"]))
        k0 = 0
    for n in ("q_norm", "k_norm"):
        if n in p:
            local[n] = tp.enter(p[n])
    return local, c0, k0


def _gathered_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
                  tp):
    """q, k and v of every head where the axis cuts inside a head: this
    rank's columns of each product (from ``x`` after ``tp.enter``)
    gathered over the axis (label ``qkv``), then normed and rotated on
    whole heads.  A replicated weight's product is computed whole from
    ``x`` itself.

    ``cat``'s backward, this rank's slice of the gradient, is right here:
    every rank computes the same attention downstream, and ``split``'s
    backward makes the output's gradient whole on every rank, so every
    rank's gradient of the gathered products is the same full tensor.  So
    are the norms' gradients: ``q_norm`` and ``k_norm`` act on every head
    and do not enter."""
    x_in = tp.enter(x)
    prods = [tp.cat(x_in @ p[n], -1, label="qkv") if p[n].shape[-1] != width else x @ p[n]
             for n, width in (("wq", cfg.n_heads * cfg.head_dim),
                              ("wk", cfg.n_kv_heads * cfg.head_dim),
                              ("wv", cfg.n_kv_heads * cfg.head_dim))]
    return _qkv_heads(cfg, p, *prods, positions)


def _query_kv(cfg: ModelConfig, t: torch.Tensor, k0: int, q0: int, nq: int) -> torch.Tensor:
    """Of ``t`` (k or v, its KV heads from ``k0``), the heads that the query
    heads ``[h0, h0 + nq)`` read (``h0 = q0 / hd``): one per query head
    where those heads part a group."""
    group = cfg.n_heads // cfg.n_kv_heads
    h0 = q0 // cfg.head_dim
    kv0, kv1 = h0 // group, (h0 + nq - 1) // group + 1
    t = t[:, :, kv0 - k0:kv1 - k0]
    if kv1 - kv0 > 1 and (h0 % group or nq % group):
        t = t[:, :, (torch.arange(h0, h0 + nq, device=t.device) // group) - kv0]
    return t


def cache_cut(cfg: ModelConfig, tp) -> Tuple[slice, slice]:
    """This rank's slices of the KV-head and ``hd`` dims of the k/v cache:
    ``dist.sharding.cache_specs``' cut (KV heads when ``KV`` divides the
    axis, else ``hd``)."""
    like = torch.empty((1, 1, 1, cfg.n_kv_heads, cfg.head_dim), device="meta")
    return cache_slices(cfg, tp.mesh, {"k": like})["k"][3:]


class _RankProjection:
    """This rank's attention (the module docstring).  On whole heads ``q`` of
    its query heads (from column ``q0``), ``k`` and ``v`` of the KV heads
    its wk/wv give (from ``k0``); where the axis cuts inside a head
    (``_inside_a_head``) q, k and v of every head, the products gathered
    (``_gathered_qkv``; ``q0 = k0 = 0``).  ``cached`` their part in this
    rank's slice of the cache; ``read`` a cache slice of whole heads turned
    into the k or v its query heads attend, ``attended`` the same of its
    own k or v; ``out`` the attention output of its query heads (of every
    head: ``ModelAxis.split`` takes this rank's columns, label
    ``attn_out_grad`` on its backward's gather) through its rows of ``wo``,
    summed over the axis.  A decode on an ``hd``-cut cache goes through
    ``_hd_decode``."""

    def __init__(self, cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, tp):
        self.cfg, self.tp, self.wo, self.dtype = cfg, tp, p["wo"], x.dtype
        self.every_head = _inside_a_head(cfg, p)
        if self.every_head:
            self.q0 = self.k0 = 0
            self.q, self.k, self.v = _gathered_qkv(cfg, p, x, positions, tp)
        else:
            local, self.q0, self.k0 = _rank_heads(cfg, p, tp)
            self.q, self.k, self.v = _project_qkv(cfg, local, tp.enter(x), positions)
        self.kv_cut, self.hd_cut = cache_cut(cfg, tp)

    def cached(self, t: torch.Tensor) -> torch.Tensor:
        a = self.kv_cut.start - self.k0
        return t[:, :, a:a + self.kv_cut.stop - self.kv_cut.start, self.hd_cut]

    def read(self, cache: torch.Tensor) -> torch.Tensor:
        return _query_kv(self.cfg, cache, self.kv_cut.start, self.q0, self.q.shape[2])

    def attended(self, t: torch.Tensor) -> torch.Tensor:
        return _query_kv(self.cfg, t, self.k0, self.q0, self.q.shape[2])

    def out(self, o: torch.Tensor) -> torch.Tensor:
        if self.every_head:
            o = self.tp.split(o, -1, label="attn_out_grad")
        return self.tp.reduce(row_partial(o, self.wo), self.dtype)


def attention_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      window: Optional[int] = None, tp=None
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Like forward but also returns the (k, v) cache; with ``tp`` the
    rank's heads, and the cache this rank's slice (``cache_cut``)."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    if tp is not None:
        r = _RankProjection(cfg, p, x, positions, tp)
        out = _attend_seq(cfg, r.q, r.attended(r.k), r.attended(r.v), positions, window)
        return r.out(out), (r.cached(r.k), r.cached(r.v))
    q, k, v = _project_qkv(cfg, p, x, positions)
    return _attend_seq(cfg, q, k, v, positions, window) @ p["wo"], (k, v)


class _Decode(NamedTuple):
    """A decode step's projection: ``q``, the new ``k`` and ``v`` as the
    cache holds them, ``read`` a cache (slice) turned into the k or v that
    ``q`` attends, ``finish`` the attention output through ``wo``, and
    ``hd_axis`` the ``ModelAxis`` when q, k and v are this rank's slice of
    ``hd`` (``_hd_decode``), else None."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    read: Callable
    finish: Callable
    hd_axis: object = None


def _hd_decode(r: _RankProjection) -> _Decode:
    """A decode step on a cache cut to ``r.hd_cut`` of ``hd`` (the module
    docstring): q, k and v of every head (the products gathered) cut to
    the slice; the attention output, gathered over ``hd``, through the
    rank's rows of ``wo``, summed over the axis."""
    sl = r.hd_cut
    return _Decode(r.q[..., sl], r.k[..., sl], r.v[..., sl], lambda c: c, r.out, r.tp)


def _decode_projection(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       positions: torch.Tensor, tp) -> _Decode:
    """A decode step's ``_Decode``: whole heads without ``tp``; on an
    ``hd``-cut cache ``_hd_decode``; else this rank's heads
    (``_RankProjection``), the new k and v its slice of the cache."""
    if tp is None:
        q, k, v = _project_qkv(cfg, p, x, positions)
        return _Decode(q, k, v, lambda c: c, lambda o: o @ p["wo"])
    r = _RankProjection(cfg, p, x, positions, tp)
    if r.hd_cut.stop - r.hd_cut.start != cfg.head_dim:
        return _hd_decode(r)
    return _Decode(r.q, r.cached(r.k), r.cached(r.v), r.read, r.out)


def attention_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                           # (B, 1, D) current token's hidden
    cache: Tuple[torch.Tensor, torch.Tensor],  # k, v (B, S, KV, hd); positions 0..S-1
    pos,                                       # int, or (B,) tensor per slot
    window: Optional[int] = None,
    static_window: Optional[int] = None,
    tp=None,
    seq=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a KV cache; writes the new k/v at ``pos``.

    ``pos`` is an int (the whole batch at one position) or a ``(B,)`` tensor
    (the serving slot pool: every slot at its own position, ``-1`` for an
    inactive slot, which writes nothing and whose reads are all masked).
    With a scalar ``pos`` and one static window over every layer,
    ``static_window`` reads only the last ``W`` cache rows.  With ``tp``
    the cache is this rank's slice and the rank runs its heads.  With
    ``seq`` (a ``dist.sharding.SequenceAxis``; scalar ``pos`` only) the
    cache holds this rank's rows of the sequence (``_decode_seq_sharded``).
    """
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        if seq is not None:
            raise ValueError("a sequence-sharded cache is decoded at one position")
        return _attention_decode_slots(cfg, p, x, cache, pos, window, tp)
    if seq is not None:
        return _decode_seq_sharded(cfg, p, x, cache, int(pos), window, static_window, tp, seq)
    k_cache, v_cache = cache
    S = k_cache.shape[1]
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    d = _decode_projection(cfg, p, x, positions, tp)
    k_cache[:, pos] = d.k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = d.v[:, 0].to(v_cache.dtype)
    if static_window is not None and static_window < S:
        W = static_window
        start = min(max(pos - W + 1, 0), S - W)
        k_read, v_read = k_cache[:, start:start + W], v_cache[:, start:start + W]
        k_positions = start + torch.arange(W, dtype=torch.int32, device=x.device)
    else:
        k_read, v_read = k_cache, v_cache
        k_positions = torch.arange(S, dtype=torch.int32, device=x.device)
    # beyond-pos rows are masked by the causal rel >= 0 test (q position == pos)
    out = _attend(cfg, d.q, d.read(k_read), d.read(v_read), positions, k_positions, window,
                  causal=True, hd_axis=d.hd_axis)
    return d.finish(out), (k_cache, v_cache)


def _write_row(cache: torch.Tensor, new: torch.Tensor, pos: int, r0: int) -> None:
    """``cache[:, pos - r0] = new[:, 0]`` on the rank whose rows ``[r0, r0 +
    n)`` of the sequence hold ``pos``; the other ranks write nothing."""
    if r0 <= pos < r0 + cache.shape[1]:
        cache[:, pos - r0] = new[:, 0].to(cache.dtype)


def _decode_seq_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor, cache, pos: int,
                        window: Optional[int], static_window: Optional[int], tp, seq):
    """``attention_decode`` on a cache whose sequence the worker axes cut
    (``seq``): this rank holds rows ``[r0, r1)`` of the ``S`` positions.

    Every rank of the worker axes computes the same q, new k and new v (its
    heads under ``tp``, or its ``hd`` slice of every head on an ``hd``-cut
    cache, as ``_decode_projection`` gives them); the rank that
    holds ``pos`` writes row ``pos - r0``.  Each rank reads the rows of the
    reference's window that it holds, ``[start, start + W) ∩ [r0, r1)`` with
    ``start = clip(pos - W + 1, 0, S - W)`` (all its rows without a static
    window), and computes its unnormalised partial (``_attend_partial``);
    the partials (B·H·(hd + 2) float32) are stacked over the worker axes
    (``SequenceAxis.parts``, one combine a layer) and combined in rank
    order (``_combine_partials``; on an ``hd``-cut cache each partial's
    logits summed over ``model`` first, and the combined output's ``hd``
    slices gathered after), then ``wo`` (and the ``model`` all-reduce)
    applies as on a whole cache.  The combine is exact: ``pos``
    is live on exactly one rank, so ``m`` is a real logit, and a rank
    whose rows miss the window, or whose rows the masks blank, has ``m_r =
    -1e30`` and weighs ``exp(-1e30 - m) = 0``.  Every rank gets the same
    bits."""
    k_cache, v_cache = cache
    S = k_cache.shape[1] * seq.size
    r0, r1 = seq.rows(S)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    d = _decode_projection(cfg, p, x, positions, tp)
    _write_row(k_cache, d.k, pos, r0)
    _write_row(v_cache, d.v, pos, r0)
    lo, hi = r0, r1
    if static_window is not None and static_window < S:
        start = min(max(pos - static_window + 1, 0), S - static_window)
        lo, hi = max(start, r0), min(start + static_window, r1)
    hi = max(lo, hi)
    k_read, v_read = d.read(k_cache[:, lo - r0:hi - r0]), d.read(v_cache[:, lo - r0:hi - r0])
    k_positions = torch.arange(lo, hi, dtype=torch.int32, device=x.device)
    part = _attend_partial(cfg, d.q, k_read, v_read, positions, k_positions, window,
                           d.hd_axis)
    out = _combine_partials(seq.parts(part), d.q.shape[-1])
    if d.hd_axis is not None:
        out = d.hd_axis.cat(out, -1, label="attn_out")
    B, Sq = d.q.shape[0], d.q.shape[1]
    return d.finish(out.reshape(B, Sq, -1).to(d.q.dtype)), (k_cache, v_cache)


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
    tp=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-slot decode: each batch row writes and reads at its own position.
    Reads stream the full cache: the causal test ``q_pos - k_pos >= 0``
    limits each slot to its own live prefix, and the sliding window (when
    configured) is enforced by the same relative-position mask."""
    k_cache, v_cache = cache
    S = k_cache.shape[1]
    positions = pos[:, None].to(torch.int32)              # (B, 1) q positions
    d = _decode_projection(cfg, p, x, positions, tp)
    _write_slots(k_cache, d.k, pos)
    _write_slots(v_cache, d.v, pos)
    k_positions = torch.arange(S, dtype=torch.int32, device=x.device)
    out = _attend(cfg, d.q, d.read(k_cache), d.read(v_cache), positions, k_positions, window,
                  causal=True, hd_axis=d.hd_axis)
    return d.finish(out), (k_cache, v_cache)
