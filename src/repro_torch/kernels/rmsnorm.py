"""ctypes binding of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Counterpart of ``repro.kernels.rmsnorm.rmsnorm_pallas``: x ``(R, D)`` in
float32 or bfloat16, scale ``(D,)`` float32, output ``(R, D)`` in x's dtype.
``rmsnorm`` takes CUDA tensors only: it checks them (``check_inputs``),
allocates the output, launches on PyTorch's current stream and raises if the
launch was refused.  The plain version is ``kernels.ref.ref_rmsnorm``;
``kernels.ops`` picks between the two by the tensors' device.  ``LAUNCHES``
counts launches, here only.  The reference's ``block_rows`` has no
counterpart: the kernel picks its own rows per block from D.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.binding import check, cuda_device, launch, library, stream

LAUNCHES = {"rmsnorm": 0}
MAX_D = 8192                         # widest row of the one-pass shape; wider rows take the second
DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rmsnorm_launch": [_P, _P, _P, _I, _I, _F, _I, _I, _P]}


def check_inputs(x, scale) -> None:
    """Raise unless the kernel takes these arguments: x ``(R, D)`` float32 or
    bfloat16 with 1 <= R, D <= 2**31 - 1, scale ``(D,)`` float32."""
    for name, t in (("x", x), ("scale", scale)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if x.dim() != 2:
        raise ValueError(f"x: expected (R, D), got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x: dtype {x.dtype}, expected one of {DTYPES}")
    R, D = x.shape
    if not (1 <= R <= 2 ** 31 - 1 and 1 <= D <= 2 ** 31 - 1):
        raise ValueError(f"R={R} and D={D} must be in [1, 2**31 - 1]")
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale: shape {tuple(scale.shape)}, expected ({D},)")


def rmsnorm(x, scale, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` per row; one launch (rows
    wider than ``MAX_D`` take the kernel's second shape)."""
    dev = cuda_device(x)
    check_inputs(x, scale)
    R, D = x.shape
    xp = check(x, "x", x.dtype, dev)
    sp = check(scale, "scale", torch.float32, dev)
    out = torch.empty_like(x)
    launch(library("rmsnorm", _SIGNATURES), LAUNCHES, "rmsnorm", "rmsnorm_launch",
           xp, sp, out.data_ptr(), R, D, float(eps), int(x.dtype == torch.bfloat16),
           dev.index, stream(dev))
    return out
