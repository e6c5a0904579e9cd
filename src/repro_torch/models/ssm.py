"""Mamba-1 selective SSM block (falcon-mamba): counterpart of ``repro.models.ssm``.

The plain path runs the recurrence as a log-depth associative scan
(``_assoc_scan``, the combination order of ``jax.lax.associative_scan``),
which materialises the ``(B, S, d_inner, n)`` state; ``cfg.ssm_chunk`` bounds
that by scanning over sequence chunks.  With ``cfg.use_pallas``, the scan
goes to the selective-scan kernel (``kernels.ops.selective_scan``), which
keeps the state out of memory (``kernel_path``): a CUDA tensor of any length
and any ``d_inner``, which the CUDA kernel takes (and a dry run's ``meta``
tensor, priced as the card runs it); on the CPU the reference's gate, a
length and a ``d_inner`` that are multiples of 64, so that the CPU keeps the
reference's route.  That dispatch is not a fallback: a CUDA tensor that
reaches the kernel launches it or raises, and so does a gradient through it
(the kernel has no backward).  On that path the kernel also
gives the final state, which ``mamba_prefill`` hands to the prefill's
caches; off it the caller recomputes the state with the plain scan, as the
reference does.

Softplus is ``jax.nn.softplus``'s ``logaddexp(x, 0)`` (no threshold) and SiLU
``x * sigmoid(x)``, each in its input's dtype, as in the reference.

Partitioned over the ``model`` axis (``mamba_forward(..., tp=)``, the
training loss on sharded placements), a rank runs the mixer on its
channels ``[r·k, (r+1)·k)`` of ``d_inner`` (``k = di/ms``), the channels
that the reference's placements give it of ``x_proj``, ``A_log``,
``out_proj`` (rows) and ``dt_w`` (columns).  ``in_proj`` stays cut on its
last dim, ``2·di``, as the reference keeps it: a rank computes its ``2k``
columns of ``x @ in_proj`` from its own shard, and the columns of its
channels' u and z, which lie on other ranks (at model=2 rank 0's product
holds all of u, rank 1's all of z), come from the owners through one
exchange of product pieces (``ModelAxis.exchange``, the reference's
collective-permute, counted in ``collectives.EXCHANGES``): u's piece from
rank ``r // 2`` at ``(r % 2)·k``, z's from rank ``(ms + r) // 2`` at
``((ms + r) % 2)·k`` (``uz_plan``), at most two pieces of ``B·S·k``
elements a rank.  The exchange's backward returns each piece's gradient to
its owner, so ``in_proj``'s gradient is the rank's own ``xᵀ`` times its
columns' gradient, with no all-reduce of the weight.  The replicated
``conv_w``, ``conv_b``, ``dt_b`` and ``D`` enter before they are sliced,
so that their gradient is the whole one on every rank.  ``x_proj`` is row-parallel: ``x_dbl``'s float32 partials are summed
once over the axis and rounded as the product in u's dtype rounds, and the
sum enters (dt_low, B and C feed this rank's channels only, so their
gradient is summed over the axis); the scan runs on the rank's channels
(the plain scan's ``(B, S, di/ms, n)`` states), and ``out_proj`` is
row-parallel, one all-reduce of float32 partials.  Serving runs the same
partition (``mamba_prefill``, ``mamba_decode`` with ``tp``): the conv and
ssm states are the rank's channels, ``dist.sharding.cache_specs``' cut of
``d_inner``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import row_partial
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def init_mamba(gen, cfg: ModelConfig, dtype, device="cpu") -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, K = cfg.dt_rank_actual, cfg.ssm_conv
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype, device=device),
        "conv_w": dense_init(gen, (K, di), dtype, scale=1.0, device=device),
        "conv_b": torch.zeros((di,), **f32),
        "x_proj": dense_init(gen, (di, dtr + 2 * n), dtype, device=device),
        "dt_w": dense_init(gen, (dtr, di), dtype, device=device),
        # softplus(dt_b) ~= 0.01 at init (standard mamba dt bias init)
        "dt_b": torch.full((di,), -4.6, **f32),
        "A_log": torch.log(torch.arange(1, n + 1, **f32)).expand(di, n).contiguous(),
        "D": torch.ones((di,), **f32),
        "out_proj": dense_init(gen, (di, d), dtype, device=device),
    }


def _causal_conv(p: Params, u: torch.Tensor, K: int) -> torch.Tensor:
    """Depthwise causal conv, kernel K: u (B, S, di) -> (B, S, di)."""
    S = u.shape[1]
    padded = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    y = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for k in range(K):  # K is 4: unrolled shifts, as in the reference
        y = y + p["conv_w"][k].to(torch.float32) * padded[:, k:k + S].to(torch.float32)
    return (y + p["conv_b"]).to(u.dtype)


def _split_x(cfg: ModelConfig, p: Params, u: torch.Tensor, tp=None):
    """u (B, S, di) -> (dt (B, S, di), B (B, S, n), C (B, S, n)), float32;
    with ``tp`` u and the leaves are this rank's channels, and ``x_proj``'s
    partials are summed over the axis (the module docstring)."""
    dtr, n = cfg.dt_rank_actual, cfg.ssm_state
    if tp is None:
        x_dbl = (u @ p["x_proj"]).to(torch.float32)
    else:
        x_dbl = tp.enter(tp.reduce(row_partial(u, p["x_proj"]), u.dtype).to(torch.float32))
    dt_low, Bmat, Cmat = torch.split(x_dbl, [dtr, n, n], dim=-1)
    dt = softplus(dt_low @ p["dt_w"].to(torch.float32) + p["dt_b"])
    return dt, Bmat, Cmat


def _ssm_inputs(cfg: ModelConfig, p: Params, u: torch.Tensor, tp=None):
    """u (B, S, di) -> (deltaA, deltaBu, C) with shapes (B, S, di, n) / (B, S, n)."""
    dt, Bmat, Cmat = _split_x(cfg, p, u, tp)
    A = -torch.exp(p["A_log"])                                   # (di, n)
    deltaA = torch.exp(dt[..., None] * A)                        # (B, S, di, n)
    deltaBu = (dt * u.to(torch.float32))[..., None] * Bmat[..., None, :]
    return deltaA, deltaBu, Cmat


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along axis 1 (len(a) is len(b) or one more)."""
    shape = list(a.shape)
    shape[1] = a.shape[1] + b.shape[1]
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _scan_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The b half of ``jax.lax.associative_scan`` of ``(a2 a1, a2 b1 + b2)``
    along axis 1, with its recursion: combine adjacent pairs, scan the half,
    then fill in the even positions.  The scanned a is never needed, so it
    is not formed (XLA drops it from the reference's program too)."""
    n = a.shape[1]
    if n < 2:
        return b
    b_odd = _scan_pairs(a[:, 1::2] * a[:, 0:-1:2], a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    b_prev = b_odd[:, :-1] if n % 2 == 0 else b_odd
    b_even = torch.cat([b[:, :1], a[:, 2::2] * b_prev + b[:, 2::2]], dim=1)
    return _interleave(b_even, b_odd)


def _assoc_scan(deltaA: torch.Tensor, deltaBu: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h[t] = deltaA[t] * h[t-1] + deltaBu[t] along axis 1 (seq)."""
    if h0 is not None:
        deltaBu = deltaBu.clone()
        deltaBu[:, 0] += deltaA[:, 0] * h0
    return _scan_pairs(deltaA, deltaBu)


def kernel_path(cfg: ModelConfig, seq_len: int, device=None) -> bool:
    """Whether a length-``seq_len`` scan on ``device`` goes to the
    selective-scan kernel: with ``use_pallas``, off the CPU (the card, and
    the dry run's ``meta`` tensors, which price the card's dispatch) at any
    length and ``d_inner`` (the CUDA kernel takes both ragged); on the CPU,
    or with no device given, the reference's gate, a length and a
    ``d_inner`` that are multiples of 64."""
    if not cfg.use_pallas:
        return False
    if device is not None and torch.device(device).type != "cpu":
        return True
    return seq_len % 64 == 0 and cfg.d_inner % 64 == 0


def mamba_mix(cfg: ModelConfig, p: Params, u: torch.Tensor, return_state: bool = False,
              tp=None):
    """Sequence mixing only (conv + selective scan), u (B, S, di) -> (B, S, di);
    with ``tp``, u and the leaves are this rank's channels (``_split_x``).

    With ``return_state``, ``(y, h_S)``: on the kernel path the kernel's final
    ``(B, di, n)`` float32 state, elsewhere None (the plain path keeps the
    reference's structure, which recomputes the state apart)."""
    u = silu(_causal_conv(p, u, cfg.ssm_conv))
    if kernel_path(cfg, u.shape[1], u.device):
        if u.device.type != "cpu" and torch.is_grad_enabled() and u.requires_grad:
            # the kernel has no backward: autograd would leave the mixer's
            # leaves without a gradient, and value_and_grad would zero them
            raise NotImplementedError(
                "the selective-scan kernel has no backward; take gradients with "
                "use_pallas off")
        # the kernel path: its inputs, without the (B, S, di, n) state
        dt, Bm, Cm = _split_x(cfg, p, u, tp)
        A = -torch.exp(p["A_log"])
        y = ops.selective_scan(u.to(torch.float32), dt, Bm.contiguous(), Cm.contiguous(),
                               A, p["D"], return_state)
        if return_state:
            return y[0].to(u.dtype), y[1]
        return y.to(u.dtype)
    y = _plain_mix(cfg, p, u, tp)
    return (y, None) if return_state else y


def _plain_mix(cfg: ModelConfig, p: Params, u: torch.Tensor, tp=None) -> torch.Tensor:
    """The plain scan of the conv output u: the associative scan over the
    (B, S, di, n) state, by ``cfg.ssm_chunk`` chunks when set."""
    deltaA, deltaBu, Cmat = _ssm_inputs(cfg, p, u, tp)
    if cfg.ssm_chunk and u.shape[1] > cfg.ssm_chunk:
        S, ck = u.shape[1], cfg.ssm_chunk
        if S % ck:
            raise ValueError(f"sequence length {S} is not a multiple of ssm_chunk={ck}")
        B, di, n = u.shape[0], u.shape[2], cfg.ssm_state
        h = torch.zeros((B, di, n), dtype=torch.float32, device=u.device)
        chunks = []
        for c in range(S // ck):
            h_seq = _assoc_scan(deltaA[:, c * ck:(c + 1) * ck],
                                deltaBu[:, c * ck:(c + 1) * ck], h0=h)
            h = h_seq[:, -1]
            chunks.append(h_seq)
        h = torch.cat(chunks, dim=1)
    else:
        h = _assoc_scan(deltaA, deltaBu)
    y = torch.einsum("bsdn,bsn->bsd", h, Cmat) + p["D"] * u.to(torch.float32)
    return y.to(u.dtype)


def _block(cfg: ModelConfig, p: Params, x: torch.Tensor, return_state: bool):
    """in_proj, the mix, the silu(z) gate and out_proj: x (B, S, D) -> (out
    (B, S, D), u (B, S, di), the mix's final state or None)."""
    u, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    y = mamba_mix(cfg, p, u, return_state)
    y, h = y if return_state else (y, None)
    return (y * silu(z)) @ p["out_proj"], u, h


def mamba_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Full mamba block: x (B, S, D) -> (B, S, D); with ``tp`` (a
    ``dist.sharding.ModelAxis``) partitioned over it (the module docstring)."""
    if tp is not None:
        return tp.reduce(_mamba_partial(cfg, p, tp.enter(x), tp), x.dtype)
    return _block(cfg, p, x, return_state=False)[0]


def _channels(cfg: ModelConfig, tp) -> int:
    """``k = di/ms``, the channels of a rank."""
    di = cfg.d_inner
    if di % tp.size:
        raise ValueError(f"the partitioned mamba mixer takes d_inner={di} in equal parts on "
                         f"the {tp.size} ranks of the model axis")
    return di // tp.size


def _rank_channels(cfg: ModelConfig, p: Params, tp) -> Params:
    """This rank's channels ``[c0, c0 + k)`` of the mixer's leaves after
    ``in_proj``.  With ``d_inner`` divisible by the axis, the placements
    cut ``x_proj``, ``A_log``, ``out_proj`` and ``dt_w`` on it (they are
    the rank's already), and leave ``conv_w``, ``conv_b``, ``dt_b`` and
    ``D`` replicated (entered, then sliced)."""
    k = _channels(cfg, tp)
    c0 = tp.rank * k
    local = {n: p[n] for n in ("x_proj", "A_log", "out_proj", "dt_w")}
    for name, dim in (("conv_w", 1), ("conv_b", 0), ("dt_b", 0), ("D", 0)):
        local[name] = tp.enter(p[name]).narrow(dim, c0, k)
    return local


@functools.lru_cache(maxsize=None)
def uz_plan(ms: int, k: int, parts: str = "uz"):
    """The exchange that gives each of ``ms`` ranks u's (``"u"``) and z's
    (``"z"``) columns of its channels from the ranks' ``2k`` columns of
    ``x @ in_proj`` (``collectives.exchange``'s plan): rank ``r``'s u
    columns ``[r·k, (r+1)·k)`` of the product, its z columns ``di`` on."""
    def piece(c):
        return c // (2 * k), c % (2 * k), k

    return tuple(tuple(piece(r * k if part == "u" else (ms + r) * k) for part in parts)
                 for r in range(ms))


def _rank_uz(cfg: ModelConfig, p: Params, x_in: torch.Tensor, tp, parts: str = "uz"):
    """This rank's channels of u and z (``parts``) from ``x_in`` (``x``
    after ``tp.enter``): its own columns of ``x @ in_proj`` (``in_proj``
    kept cut), then the pieces of its channels exchanged
    (``uz_plan``)."""
    k = _channels(cfg, tp)
    if p["in_proj"].shape[-1] != 2 * k:
        raise ValueError(f"the partitioned mamba mixer takes in_proj cut on its last dim, "
                         f"{2 * k} columns a rank; it holds {p['in_proj'].shape[-1]}")
    return tp.exchange(x_in @ p["in_proj"], uz_plan(tp.size, k, parts), -1, label="mixer_uz")


def _partial_block(cfg: ModelConfig, p: Params, x_in: torch.Tensor, tp, return_state: bool):
    """``_block`` on this rank's channels, from ``x_in`` (``x`` after
    ``tp.enter``): (its float32 partial of the output, the row-parallel
    ``out_proj`` last; its u; the mix's final state on its channels or
    None)."""
    u, z = _rank_uz(cfg, p, x_in, tp)
    local = _rank_channels(cfg, p, tp)
    y = mamba_mix(cfg, local, u, return_state, tp=tp)
    y, h = y if return_state else (y, None)
    return row_partial(y * silu(z), local["out_proj"]), u, h


def _mamba_partial(cfg: ModelConfig, p: Params, x_in: torch.Tensor, tp) -> torch.Tensor:
    """This rank's float32 partial of the mamba block's output, from
    ``x_in`` (``x`` after ``tp.enter``)."""
    return _partial_block(cfg, p, x_in, tp, return_state=False)[0]


def mamba_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor, tp=None):
    """The mamba block over a prompt, with the state a decode continues from:
    x (B, S, D) -> (out (B, S, D), (conv_state (B, K-1, di), ssm_state (B,
    di, n)) or None).  On the kernel path the ssm state is the kernel's final
    state and the conv state the last K-1 rows of the same ``in_proj``
    output; off it the state is None, and the caller recomputes it as the
    reference does.  With ``tp`` the block runs on this rank's channels and
    the state is its slice of ``d_inner``."""
    if tp is None:
        out, u, h = _block(cfg, p, x, return_state=True)
    else:
        part, u, h = _partial_block(cfg, p, tp.enter(x), tp, return_state=True)
        out = tp.reduce(part, x.dtype)
    if h is None:
        return out, None
    # a copy, so that no cached view keeps the layer's u alive
    return out, (u[:, -(cfg.ssm_conv - 1):, :].clone(), h)


# --------------------------------------------------------------------------- #
# decode (single-token recurrence)
# --------------------------------------------------------------------------- #
def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(conv_state (B, K-1, di), ssm_state (B, di, n))."""
    return (
        torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
    )


def mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 state: Tuple[torch.Tensor, torch.Tensor], tp=None):
    """One token: x (B, 1, D) and (conv_state, ssm_state) -> (out (B, 1, D),
    (new conv_state, new ssm_state)); the state is returned, not written.
    With ``tp`` the state is this rank's slice of ``d_inner`` and the step
    runs on its channels (``_rank_uz``: one exchange of ``B·k`` product
    columns; ``_rank_channels``; ``x_proj`` and ``out_proj`` row-parallel,
    an all-reduce each)."""
    conv_state, h = state
    if tp is None:
        u, z = torch.chunk(x[:, 0] @ p["in_proj"], 2, dim=-1)    # (B, di)
    else:
        u, z = _rank_uz(cfg, p, tp.enter(x[:, 0]), tp)
        p = _rank_channels(cfg, p, tp)
    window = torch.cat([conv_state, u[:, None]], dim=1)            # (B, K, di)
    conv_y = torch.einsum("bkd,kd->bd", window.to(torch.float32),
                          p["conv_w"].to(torch.float32))
    u_c = silu(conv_y + p["conv_b"]).to(u.dtype)
    deltaA, deltaBu, Cmat = _ssm_inputs(cfg, p, u_c[:, None], tp)  # seq dim 1
    h = deltaA[:, 0] * h + deltaBu[:, 0]                           # (B, di, n)
    y = torch.einsum("bdn,bn->bd", h, Cmat[:, 0]) + p["D"] * u_c.to(torch.float32)
    if tp is None:
        out = (y.to(x.dtype) * silu(z)) @ p["out_proj"]
    else:
        out = tp.reduce(row_partial(y.to(x.dtype) * silu(z), p["out_proj"]), x.dtype)
    return out[:, None], (window[:, 1:], h)
