"""Plain PyTorch versions of the port's kernels (the oracles).

Counterpart of ``repro.kernels.ref``: the ZO-direction kernels, flash
attention, the selective scan and RMSNorm.  On a CPU tensor the
wrappers in ``repro_torch.kernels.ops`` run these functions; on the card the
CUDA kernels are held against them.  The flat versions take the same
per-block metadata as the kernels (leaf salt, leaf-local counter start, valid
lanes) and evaluate block by block: the whole packed buffer is viewed as
``(n_blocks, block)`` and every block hashes its own counters, so padding
lanes are masked exactly as in the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.directions import MASK, gaussian_from_counters, gaussian_from_salt
from repro_torch.dtypes import acc_dtype_of


def _f32(v, device) -> torch.Tensor:
    """float32 tensor of ``v`` on ``device``; a Python scalar is written by a
    fill, so no blocking host-to-device copy is made on the card."""
    if isinstance(v, (int, float)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _round(acc: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    """Round the float32 accumulator through ``adt`` (no-op for float32)."""
    return acc if adt == torch.float32 else acc.to(adt).to(torch.float32)


# --------------------------------------------------------------------------- #
# norm and selective scan
# --------------------------------------------------------------------------- #
def ref_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last axis, in
    float32, rounded once to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))).to(x.dtype)


def ref_selective_scan(u, dt, Bmat, Cmat, A, D, return_state: bool = False):
    """The Mamba-1 recurrence, one time step after another: u and dt
    ``(B, S, di)``, Bmat and Cmat ``(B, S, n)``, A ``(di, n)``, D ``(di,)``;
    ``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t`` and ``y_t = h_t . C_t +
    D u_t``, with a float32 state from 0 and the output in u's dtype.  With
    ``return_state``, ``(y, h_S)``: the float32 ``(B, di, n)`` state it ends
    with."""
    uf, dtf = u.to(torch.float32), dt.to(torch.float32)
    Bf, Cf = Bmat.to(torch.float32), Cmat.to(torch.float32)
    A, D = A.to(torch.float32), D.to(torch.float32)
    B, S, di = u.shape
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(S):
        u_t, dt_t = uf[:, t], dtf[:, t]
        dA = torch.exp(dt_t[..., None] * A)
        dBu = (dt_t * u_t)[..., None] * Bf[:, t, None, :]
        h = dA * h + dBu
        ys.append(torch.sum(h * Cf[:, t, None, :], dim=-1) + D * u_t)
    y = torch.stack(ys, dim=1).to(u.dtype)
    return (y, h) if return_state else y


# --------------------------------------------------------------------------- #
# per-leaf oracles
# --------------------------------------------------------------------------- #
def ref_zo_sumsq(n: int, salt, offset=0, device="cpu") -> torch.Tensor:
    """``sum v^2`` of one leaf's ``n`` Gaussians (a 0-d float32 tensor)."""
    g = gaussian_from_salt((int(n),), salt, offset, device=device)
    return torch.sum(g * g)


def run_length(n: int, starts, offset=0) -> int:
    """The run length of a per-leaf call on ``n`` values: ``n`` for one run
    at ``offset`` (``starts`` None), else ``n / len(starts)``, which must be
    whole; a run table and a nonzero offset together raise (the table holds
    every run's start)."""
    if starts is None:
        return n
    runs = int(starts.shape[0]) if starts.dim() == 1 else -1
    if runs < 1 or n % runs:
        raise ValueError(f"starts: shape {tuple(starts.shape)} does not cut {n} values into "
                         f"equal runs")
    if int(offset) & MASK:
        raise ValueError("a run table holds every run's start: pass offset=0 with starts")
    return n // runs


def leaf_counters(n: int, offset=0, starts=None, device="cpu") -> torch.Tensor:
    """The hash counters of a per-leaf kernel's ``n`` values (int64, mod
    2**32): ``offset + i``, or with a run table ``starts`` (``n / len(starts)``
    values a run) ``starts[r] + j`` for value ``r * run + j``."""
    run = run_length(int(n), starts, offset)
    lanes = torch.arange(run, dtype=torch.int64, device=device)
    if starts is None:
        return (lanes + (int(offset) & MASK)) & MASK
    first = starts.to(device=device, dtype=torch.int64)
    return ((first[:, None] + lanes[None, :]) & MASK).reshape(-1)


def ref_zo_perturb(x: torch.Tensor, salt, scale, offset=0, starts=None) -> torch.Tensor:
    """``(f32(x) + scale * v).to(x.dtype)``, v at ``leaf_counters``."""
    g = gaussian_from_counters(leaf_counters(x.numel(), offset, starts, x.device), salt)
    return (x.to(torch.float32) + _f32(scale, x.device) * g.reshape(x.shape)).to(x.dtype)


def ref_zo_reconstruct(n: int, salts, coeffs, offset=0, acc_dtype="float32",
                       device="cpu", starts=None) -> torch.Tensor:
    """``sum_w coeffs[w] * v_w`` over one leaf at ``leaf_counters``, rounding
    the accumulator to ``acc_dtype`` after each worker; ``salts`` holds m
    salts (ints or a tensor on the CPU)."""
    adt = acc_dtype_of(acc_dtype)
    coeffs = _f32(coeffs, device)
    idx = leaf_counters(n, offset, starts, device)
    acc = torch.zeros((n,), dtype=torch.float32, device=device)
    for w in range(int(coeffs.shape[0])):
        acc = _round(acc + coeffs[w] * gaussian_from_counters(idx, int(salts[w])), adt)
    return acc


# --------------------------------------------------------------------------- #
# flat (packed multi-leaf) oracles
# --------------------------------------------------------------------------- #
def _ref_flat_gauss(salt, ctr, nvalid, block: int, device="cpu") -> torch.Tensor:
    """One block's Gaussians, padding lanes zeroed."""
    g = gaussian_from_salt((block,), int(salt), int(ctr), device=device)
    lanes = torch.arange(block, device=device)
    return torch.where(lanes < int(nvalid), g, torch.zeros_like(g))


def _flat_gauss(salts, ctrs, nvalid, block: int):
    """``(n_blocks, block)`` Gaussians of every block and the valid-lane
    mask; ``salts`` may carry a trailing worker axis sliced by the caller."""
    lanes = torch.arange(block, dtype=torch.int64, device=ctrs.device)
    idx = (ctrs.to(torch.int64)[:, None] + lanes[None, :]) & MASK
    g = gaussian_from_counters(idx, salts.to(torch.int64)[:, None])
    valid = lanes[None, :] < nvalid.to(torch.int64)[:, None]
    return g, valid


def _blocks(x: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    if x.numel() != nb * block:
        raise ValueError(f"buffer of {x.numel()} values is not {nb} blocks "
                         f"of {block}")
    return x.reshape(nb, block)


def ref_zo_perturb_flat(x, salts, ctrs, nvalid, scale, block: int = 4096):
    """Whole-buffer ``x + scale * v``; padding lanes pass through."""
    nb = int(salts.shape[0])
    xb = _blocks(x, nb, block)
    g, valid = _flat_gauss(salts, ctrs, nvalid, block)
    return torch.where(valid, xb + _f32(scale, x.device) * g, xb).reshape(-1)


def ref_zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block: int = 4096,
                            acc_dtype="float32") -> torch.Tensor:
    """Whole-buffer ``sum_w coeffs[w] * v_w`` with per-worker ``acc_dtype``
    rounding; padding lanes 0.  ``salts`` is ``(n_blocks, m)``."""
    adt = acc_dtype_of(acc_dtype)
    nb, m = (int(s) for s in salts.shape)
    coeffs = _f32(coeffs, ctrs.device)
    acc = torch.zeros((nb, block), dtype=torch.float32, device=ctrs.device)
    valid = None
    for w in range(m):
        g, valid = _flat_gauss(salts[:, w], ctrs, nvalid, block)
        acc = _round(acc + coeffs[w] * g, adt)
    return torch.where(valid, acc, torch.zeros_like(acc)).reshape(-1)


def ref_zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block: int = 4096):
    """Fused perturb + norm: ``(x + mu*rsqrt(sumsq + 1e-30)*v, sumsq)`` with
    ``sumsq`` of shape (1,).  The sum is taken as the reference's Pallas
    kernel takes it: one partial per block, then one sum over the partials
    (the CUDA kernel sums in an order of its own, as fixed)."""
    nb = int(salts.shape[0])
    xb = _blocks(x, nb, block)
    g, valid = _flat_gauss(salts, ctrs, nvalid, block)
    g = torch.where(valid, g, torch.zeros_like(g))
    ss = torch.sum(torch.sum(g * g, dim=1))
    scale = _f32(mu, x.device) * torch.rsqrt(ss + 1e-30)
    out = torch.where(valid, xb + scale * g, xb)
    return out.reshape(-1), ss.reshape(1)


def ref_zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs,
                              lr, momentum: float = 0.0, block: int = 4096,
                              acc_dtype="float32"):
    """Fused reconstruct + SGD(+momentum) commit; returns new ``(p', mom')``
    (``mom'`` None when ``mom`` is None).  The commit is ``p + (-lr) * v``,
    the expression ``apply_deltas(sgd.update(...))`` evaluates; blocks
    flagged in ``bf16_mask`` round the new params through bfloat16."""
    nb = int(salts.shape[0])
    g_full = ref_zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block,
                                     acc_dtype)
    neg_lr = -_f32(lr, p.device)
    p32 = p.to(torch.float32)
    if mom is not None:
        v_new = _f32(momentum, p.device) * mom.to(torch.float32) + g_full
        p_new = p32 + neg_lr * v_new
    else:
        v_new = None
        p_new = p32 + neg_lr * g_full
    bf = (bf16_mask != 0).repeat_interleave(block)
    if bf.numel() != nb * block:
        raise ValueError("bf16_mask must have one flag per block")
    p_new = torch.where(bf, p_new.to(torch.bfloat16).to(torch.float32), p_new)
    return p_new, v_new


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
def ref_flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """What the flash kernel computes, written out: q ``(B, Sq, H, hd)``, k
    and v ``(B, Sk, KV, hd)``; query head h reads KV head ``h // (H // KV)``.
    float32 throughout, q scaled by the float32 of 1/sqrt(hd) before the
    product, softcap ``c * tanh(s / c)`` before the mask, causal and window
    masks on positions 0.. of both sides, masked logits -1e30; the output is
    rounded once to q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = (q.to(torch.float32) * (1.0 / hd ** 0.5)).reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rel = (torch.arange(Sq, device=q.device)[:, None]
           - torch.arange(Sk, device=q.device)[None, :])
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)
