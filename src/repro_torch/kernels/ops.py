"""The kernels' wrappers: plain version on CPU, kernel on CUDA.

Counterpart of ``repro.kernels.ops`` for the four flat ZO-direction kernels
and flash attention.  A wrapper picks by the device of the tensor it is
given: a CPU tensor goes to the plain PyTorch version (``kernels.ref``); a
CUDA tensor launches the hand-written kernel (``kernels.zo_direction``,
``kernels.flash_attention``) or raises.  Nothing falls back.

Metadata dtypes: ``salts``/``ctrs`` are ``torch.uint32``, ``nvalid`` and
``bf16_mask`` ``torch.int32``, everything else float32.  ``scale``, ``mu`` and
``lr`` may be Python floats or tensors.  ``zo_reconstruct_update`` updates
``p`` and ``mom`` in place on both paths and returns them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import zo_direction as _cu

_COUNTS = (_cu.LAUNCHES, _fa.LAUNCHES)


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {k: n for counts in _COUNTS for k, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


def zo_perturb_flat(x, salts, ctrs, nvalid, scale, block: int = 4096):
    if _on_cpu(x, "zo_perturb_flat"):
        return ref.ref_zo_perturb_flat(x, salts, ctrs, nvalid, scale, block)
    return _cu.zo_perturb_flat(x, salts, ctrs, nvalid, scale, block)


def zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block: int = 4096,
                        acc_dtype="float32"):
    if _on_cpu(ctrs, "zo_reconstruct_flat"):
        return ref.ref_zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block,
                                           acc_dtype)
    return _cu.zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block, acc_dtype)


def zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block: int = 4096):
    if _on_cpu(x, "zo_perturb_sumsq"):
        return ref.ref_zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block)
    return _cu.zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block)


def zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs, lr,
                          momentum: float = 0.0, block: int = 4096,
                          acc_dtype="float32"):
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


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """GQA attention in the model's layout: q ``(B, Sq, H, hd)``, k and v
    ``(B, Sk, KV, hd)`` -> ``(B, Sq, H, hd)``.  The reference's ``block_q`` /
    ``block_k`` have no counterpart: the CUDA kernel's tiles are its own."""
    if _on_cpu(q, "flash_attention"):
        return ref.ref_flash_attention(q, k, v, causal, window, softcap)
    return _fa.flash_attention(q, k, v, causal, window, softcap)
