"""ctypes binding of the CUDA selective-scan kernel (``csrc/selective_scan.cu``).

Counterpart of ``repro.kernels.selective_scan.selective_scan_pallas``: u and
dt ``(B, S, di)``, Bmat and Cmat ``(B, S, n)`` of one dtype (float32 or
bfloat16), A ``(di, n)`` and D ``(di,)`` float32; the output ``(B, S, di)`` is
in u's dtype.  ``selective_scan`` takes CUDA tensors only: it checks them
(``check_inputs``), allocates the output, launches on PyTorch's current
stream and raises if the launch was refused.  The plain version is
``kernels.ref.ref_selective_scan``; ``kernels.ops`` picks between the two by
the tensors' device.  ``LAUNCHES`` counts launches, here only.  The
reference's ``block_d`` / ``block_s`` have no counterpart: the kernel's
tiles are its own.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.binding import check, cuda_device, launch, library, stream

LAUNCHES = {"selective_scan": 0}
MAX_STATE = 64                       # n the kernel takes (16 lanes x 4 states)
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"selective_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _P]}


def check_inputs(u, dt, Bmat, Cmat, A, D) -> None:
    """Raise unless the kernel takes these arguments: u and dt ``(B, S,
    di)``, Bmat and Cmat ``(B, S, n)``, all four of one dtype (float32 or
    bfloat16), A ``(di, n)`` and D ``(di,)`` float32, S, di >= 1,
    1 <= n <= ``MAX_STATE``, B <= 65535."""
    for name, t in (("u", u), ("dt", dt), ("Bmat", Bmat), ("Cmat", Cmat), ("A", A), ("D", D)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if u.dim() != 3:
        raise ValueError(f"u: expected (B, S, di), got shape {tuple(u.shape)}")
    if u.dtype not in DTYPES:
        raise TypeError(f"u: dtype {u.dtype}, expected one of {DTYPES}")
    B, S, di = u.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A: expected ({di}, n), got shape {tuple(A.shape)}")
    n = A.shape[1]
    want = {"dt": (B, S, di), "Bmat": (B, S, n), "Cmat": (B, S, n), "D": (di,)}
    for name, t in (("dt", dt), ("Bmat", Bmat), ("Cmat", Cmat), ("D", D)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want[name]}")
    if min(B, S, di) < 1 or not 1 <= n <= MAX_STATE:
        raise ValueError(f"B={B}, S={S}, di={di} must be positive and n={n} "
                         f"in [1, {MAX_STATE}]")
    if B > 65535:
        raise ValueError(f"B = {B} blocks exceed the grid's 65535 rows")


def selective_scan(u, dt, Bmat, Cmat, A, D) -> torch.Tensor:
    """``y_t = h_t . C_t + D u_t`` with ``h_t = exp(dt_t A) h_{t-1} + (dt_t
    u_t) B_t`` from ``h_0 = 0``; one launch."""
    dev = cuda_device(u)
    check_inputs(u, dt, Bmat, Cmat, A, D)
    B, S, di = u.shape
    n = A.shape[1]
    ptrs = [check(t, name, u.dtype, dev) for name, t in
            (("u", u), ("dt", dt), ("Bmat", Bmat), ("Cmat", Cmat))]
    ptrs += [check(t, name, torch.float32, dev) for name, t in (("A", A), ("D", D))]
    out = torch.empty_like(u)
    launch(library("selective_scan", _SIGNATURES), LAUNCHES, "selective_scan",
           "selective_scan_launch", *ptrs, out.data_ptr(), B, S, di, n,
           int(u.dtype == torch.bfloat16), dev.index, stream(dev))
    return out
