"""ctypes binding of the CUDA selective-scan kernel (``csrc/selective_scan.cu``).

Counterpart of ``repro.kernels.selective_scan.selective_scan_pallas``: u and
dt ``(B, S, di)``, Bmat and Cmat ``(B, S, n)`` of one dtype (float32 or
bfloat16), A ``(di, n)`` and D ``(di,)`` float32; the output ``(B, S, di)`` is
in u's dtype, and with ``return_state`` the final state ``(B, di, n)`` in
float32 comes with it.  ``selective_scan`` takes CUDA tensors only: it checks
them (``check_inputs``), allocates the outputs (and, for n > ``GROUP``, the
groups' partial sums), launches on PyTorch's current stream and raises if the
launch was refused.  The plain version is ``kernels.ref.ref_selective_scan``;
``kernels.ops`` picks between the two by the tensors' device.  ``LAUNCHES``
counts launches, here only.  The reference's ``block_d`` / ``block_s`` have no
counterpart: the kernel's tiles are its own.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.binding import check, cuda_device, launch, library, stream

LAUNCHES = {"selective_scan": 0}
GROUP = 64                           # states one block holds; more go in groups
LANES = (2, 4, 8)                    # lanes per channel of the n <= 16 variants
SERVED_LANES = 4                     # the fastest at falcon-mamba-7b's width; chip_smoke
                                     # fails if another variant is clearly faster
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"selective_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _I, _I, _I, _P]}


def check_inputs(u, dt, Bmat, Cmat, A, D) -> None:
    """Raise unless the kernel takes these arguments: u and dt ``(B, S,
    di)``, Bmat and Cmat ``(B, S, n)``, all four of one dtype (float32 or
    bfloat16), A ``(di, n)`` and D ``(di,)`` float32, B, S, di, n >= 1, and
    grid dimensions the card takes (B x ceil(di / 16) blocks under 2**31,
    ceil(n / ``GROUP``) under 65536)."""
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
    if min(B, S, di, n) < 1:
        raise ValueError(f"B={B}, S={S}, di={di} and n={n} must be positive")
    if B * -(-di // 16) >= 2 ** 31 or -(-n // GROUP) > 65535:
        raise ValueError(f"B={B}, di={di}, n={n} exceed the card's grid")


def selective_scan(u, dt, Bmat, Cmat, A, D, return_state: bool = False,
                   _lanes: Optional[int] = None):
    """``y_t = h_t . C_t + D u_t`` with ``h_t = exp(dt_t A) h_{t-1} + (dt_t
    u_t) B_t`` from ``h_0 = 0``; with ``return_state``, ``(y, h_S)``.  One
    launch (a second pass sums the state groups when n > ``GROUP``).
    ``_lanes`` picks another n <= 16 variant than ``SERVED_LANES`` (one of
    ``LANES``), for the A/B that chose it; no model passes it."""
    dev = cuda_device(u)
    check_inputs(u, dt, Bmat, Cmat, A, D)
    lanes = SERVED_LANES if _lanes is None else _lanes
    if lanes not in LANES:
        raise ValueError(f"lanes={lanes}, expected one of {LANES}")
    B, S, di = u.shape
    n = A.shape[1]
    ptrs = [check(t, name, u.dtype, dev) for name, t in
            (("u", u), ("dt", dt), ("Bmat", Bmat), ("Cmat", Cmat))]
    ptrs += [check(t, name, torch.float32, dev) for name, t in (("A", A), ("D", D))]
    out = torch.empty_like(u)
    groups = -(-n // GROUP)
    part = (torch.empty((groups, B, S, di), dtype=torch.float32, device=dev)
            if groups > 1 else None)
    h_last = (torch.empty((B, di, n), dtype=torch.float32, device=dev)
              if return_state else None)
    launch(library("selective_scan", _SIGNATURES), LAUNCHES, "selective_scan",
           "selective_scan_launch", *ptrs, out.data_ptr(),
           None if part is None else part.data_ptr(),
           None if h_last is None else h_last.data_ptr(), B, S, di, n, lanes,
           int(u.dtype == torch.bfloat16), dev.index, stream(dev))
    return (out, h_last) if return_state else out
