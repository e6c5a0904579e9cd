"""ctypes binding of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``, in
the model's layout: q ``(B, Sq, H, hd)``, k and v ``(B, Sk, KV, hd)``, output
``(B, Sq, H, hd)`` in q's dtype.  ``flash_attention`` takes CUDA tensors
only: it checks them (``check_inputs``), allocates the output, launches on
PyTorch's current stream and raises if the launch was refused.  The plain
version is ``kernels.ref.ref_flash_attention``; ``kernels.ops`` picks between
the two by the tensors' device.

Two kernels, both on the tensor cores, picked by ``variant(dtype, hd)`` with
no fallback: bf16 inputs run ``"wgmma"`` (P split into two bf16 halves),
float32 inputs ``"tf32x3"`` (q, k, v and P each split into two TF32 halves,
three TF32 products per matrix product).  ``LAUNCHES`` counts launches, here
only: the total under ``"flash_attention"``, each variant's under
``"flash_attention_<variant>"`` and each head width's under
``"flash_attention_hd<hd>"``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.binding import check, cuda_device, launch, library, stream

TILE = 64                            # query and key rows per tile of the kernel
HEAD_DIMS = (32, 64, 80, 96, 128, 256)   # every config's head width (and reduced())
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0, "flash_attention_tf32x3": 0,
            **{f"flash_attention_hd{hd}": 0 for hd in HEAD_DIMS}}
DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]
_SIGNATURES = {"flash_attention_wgmma_launch": _ARGS, "flash_attention_tf32x3_launch": _ARGS}


def variant(dtype: torch.dtype, hd: int) -> str:
    """Which kernel takes inputs of ``dtype`` and head width ``hd``, at every
    width of ``HEAD_DIMS``: bf16 the bf16 tensor-core kernel, float32 the one
    that forms each float32 product from three TF32 products (hi*hi + hi*lo
    + lo*hi, hi = tf32(x), lo = tf32(x - hi))."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "tf32x3"
    raise TypeError(f"dtype {dtype}, expected one of {DTYPES}")


def check_inputs(q, k, v, window: Optional[int], softcap: Optional[float]) -> None:
    """Raise unless the kernel takes these arguments: 4-d tensors of one
    dtype (float32 or bfloat16) on one device, k and v of one shape, equal
    batch and head width, H a multiple of KV, hd in ``HEAD_DIMS``, Sq and Sk
    multiples of ``TILE``, a positive window and softcap when given, and a
    grid the card takes (B * H blocks on x under 2**31, Sq / ``TILE`` on y
    under 65536)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name}: expected a 4-d tensor")
    if q.dtype not in DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected one of {DTYPES}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B, S, heads, hd)")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {HEAD_DIMS}")
    if Sq % TILE or Sk % TILE or Sq == 0 or Sk == 0:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be positive multiples of {TILE}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if B * H >= 2 ** 31 or Sq // TILE > 65535:
        raise ValueError(f"B * H = {B * H} or Sq = {Sq} exceed the card's grid")


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """``softmax(mask(softcap(q k^T / sqrt(hd)))) v`` per query head, reading
    KV head ``h // (H // KV)``; one launch of ``variant(q.dtype, hd)``."""
    dev = cuda_device(q)
    check_inputs(q, k, v, window, softcap)
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    ptrs = [check(t, name, q.dtype, dev) for name, t in (("q", q), ("k", k), ("v", v))]
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    out = torch.empty_like(q)
    # the Pallas kernel's scale: the float32 of 1/sqrt(hd)
    scale = 1.0 / hd ** 0.5
    name = variant(q.dtype, hd)
    launch(library("flash_attention", _SIGNATURES), LAUNCHES,
           ("flash_attention", f"flash_attention_{name}", f"flash_attention_hd{hd}"),
           f"flash_attention_{name}_launch",
           *ptrs, out.data_ptr(), B, Sq, Sk, H, KV, hd, int(bool(causal)),
           -1 if window is None else min(int(window), 2 ** 31 - 1),
           0.0 if softcap is None else float(softcap), scale, dev.index, stream(dev))
    return out
