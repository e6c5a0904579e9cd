"""The kernels' wrappers: plain version on CPU, kernel on CUDA.

Counterpart of ``repro.kernels.ops`` for the seven ZO-direction kernels (four
flat, three per leaf), flash attention, the selective scan and RMSNorm.  A
wrapper picks by the device of the tensor it is given: a CPU tensor goes to
the plain PyTorch version (``kernels.ref``); a CUDA tensor launches the
hand-written kernel (``kernels.zo_direction``, ``kernels.flash_attention``,
``kernels.selective_scan``, ``kernels.rmsnorm``) or raises.  Nothing falls
back.  A tensor without data (the ``meta`` device, or a fake tensor of
``torch._subclasses.fake_tensor``: the dry run, ``launch.dryrun``) goes to
the kernel's operator in ``kernels.fake``, which gives the outputs' shapes
and dtypes and never runs on data.

Metadata dtypes: ``salts``/``ctrs`` are ``torch.uint32``, ``nvalid`` and
``bf16_mask`` ``torch.int32``, everything else float32.  ``scale``, ``mu`` and
``lr`` may be Python floats or tensors on the CPU; on the card ``scale`` may
also be a tensor there, while ``zo_perturb_sumsq``'s ``mu`` and
``zo_reconstruct_update``'s ``lr`` go by value, a host number or a CPU tensor
(a tensor on the card raises).  ``zo_reconstruct_update`` updates
``p`` and ``mom`` in place on both paths and returns them.  A per-leaf salt
and counter offset are Python ints; ``zo_reconstruct`` takes its m salts as
a uint32 tensor on the coefficients' device.  ``zo_perturb`` and
``zo_reconstruct`` take a shard of a leaf as a run table ``starts`` (uint32,
on the tensors' device; ``ref.leaf_counters``) in place of the offset.  The reference's ``block``
argument has no counterpart here: the CUDA kernels' tiles are their own.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import fake as _fk
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import zo_direction as _cu

_COUNTS = (_cu.LAUNCHES, _fa.LAUNCHES, _ss.LAUNCHES, _rn.LAUNCHES)
_no_data = _fk.no_data


def _on_cpu(t, what: str) -> bool:
    """Whether tensor (or device) ``t`` is on the CPU; False on the card,
    and any other device raises."""
    dev = t.device if isinstance(t, torch.Tensor) else torch.device(t)
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"{what}: unsupported device {dev}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {k: n for counts in _COUNTS for k, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


def zo_perturb_flat(x, salts, ctrs, nvalid, scale, block: int = 4096):
    if _no_data(x):
        return _fk.zo_perturb_flat(x, salts, ctrs, nvalid, scale, block)
    if _on_cpu(x, "zo_perturb_flat"):
        return ref.ref_zo_perturb_flat(x, salts, ctrs, nvalid, scale, block)
    return _cu.zo_perturb_flat(x, salts, ctrs, nvalid, scale, block)


def zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block: int = 4096,
                        acc_dtype="float32"):
    if _no_data(ctrs):
        return _fk.zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block)
    if _on_cpu(ctrs, "zo_reconstruct_flat"):
        return ref.ref_zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block,
                                           acc_dtype)
    return _cu.zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block, acc_dtype)


def zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block: int = 4096):
    if _no_data(x):
        return _fk.zo_perturb_sumsq(x, salts, ctrs, nvalid, block)
    if _on_cpu(x, "zo_perturb_sumsq"):
        return ref.ref_zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block)
    return _cu.zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block)


def zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs, lr,
                          momentum: float = 0.0, block: int = 4096,
                          acc_dtype="float32"):
    if _no_data(p):
        return _fk.zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs,
                                         block)
    if _on_cpu(p, "zo_reconstruct_update"):
        p_new, v_new = ref.ref_zo_reconstruct_update(
            p, mom, salts, ctrs, nvalid, bf16_mask, coeffs, lr, momentum,
            block, acc_dtype)
        p.copy_(p_new)
        if mom is not None:
            mom.copy_(v_new)
        return p, mom
    return _cu.zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask,
                                     coeffs, lr, momentum, block, acc_dtype)


def zo_sumsq(n: int, salt, offset=0, *, device) -> torch.Tensor:
    """``sum v^2`` of one leaf (a 0-d float32 tensor on ``device``); there is
    no tensor input, so the device is named."""
    if _no_data(device):
        return _fk.zo_sumsq(n, salt, offset, device)
    if _on_cpu(device, "zo_sumsq"):
        return ref.ref_zo_sumsq(n, salt, offset)
    return _cu.zo_sumsq(n, salt, offset, device)


def zo_perturb(x, salt, scale, offset=0, starts=None):
    if _no_data(x):
        return _fk.zo_perturb(x, salt, scale, offset, starts)
    if _on_cpu(x, "zo_perturb"):
        return ref.ref_zo_perturb(x, salt, scale, offset, starts)
    return _cu.zo_perturb(x, salt, scale, offset, starts)


def zo_reconstruct(n: int, salts, coeffs, offset=0, acc_dtype="float32", starts=None):
    if _no_data(coeffs):
        return _fk.zo_reconstruct(n, salts, coeffs, offset, starts)
    if _on_cpu(coeffs, "zo_reconstruct"):
        return ref.ref_zo_reconstruct(n, salts, coeffs, offset, acc_dtype, starts=starts)
    return _cu.zo_reconstruct(n, salts, coeffs, offset, acc_dtype, starts)


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """GQA attention in the model's layout: q ``(B, Sq, H, hd)``, k and v
    ``(B, Sk, KV, hd)`` -> ``(B, Sq, H, hd)``.  On the card bf16 runs the
    bf16 kernel and float32 the TF32x3 one, both on the tensor cores
    (``flash_attention.variant``).
    The reference's ``block_q`` / ``block_k`` have no counterpart: the CUDA
    kernels' tiles are their own."""
    if _no_data(q):
        return _fk.flash_attention(q, k, v, causal, window, softcap)
    if _on_cpu(q, "flash_attention"):
        return ref.ref_flash_attention(q, k, v, causal, window, softcap)
    return _fa.flash_attention(q, k, v, causal, window, softcap)


def selective_scan(u, dt, Bmat, Cmat, A, D, return_state: bool = False):
    """The Mamba-1 scan: u and dt ``(B, S, di)``, Bmat and Cmat ``(B, S, n)``,
    A ``(di, n)``, D ``(di,)`` -> ``(B, S, di)`` in u's dtype; with
    ``return_state`` also the final state ``(B, di, n)`` in float32.  The
    reference's ``block_d`` / ``block_s`` have no counterpart: the CUDA
    kernel's tiles are its own."""
    if _no_data(u):
        return _fk.selective_scan(u, dt, Bmat, Cmat, A, D, return_state)
    if _on_cpu(u, "selective_scan"):
        return ref.ref_selective_scan(u, dt, Bmat, Cmat, A, D, return_state)
    return _ss.selective_scan(u, dt, Bmat, Cmat, A, D, return_state)


def rmsnorm(x, scale, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, any leading shape; the reference's
    ``block_rows`` has no counterpart (the CUDA kernel picks its own rows
    per block)."""
    if _no_data(x):
        return _fk.rmsnorm(x, scale, eps)
    if _on_cpu(x, "rmsnorm"):
        return ref.ref_rmsnorm(x, scale, eps)
    flat = x.reshape(-1, x.shape[-1])
    return _rn.rmsnorm(flat, scale, eps).reshape(x.shape)
