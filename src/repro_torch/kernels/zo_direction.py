"""ctypes binding of the CUDA kernels in ``csrc/zo_direction.cu``.

Counterpart of the flat kernels of ``repro.kernels.zo_direction``.  Each
function here takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch was refused.  There is no fallback:
the plain versions live in ``repro_torch.kernels.ref`` and
``repro_torch.kernels.ops`` picks between the two by the tensors' device.

The library is built (``kernels.build``) and loaded at the first launch, never
at import.  ``LAUNCHES`` counts kernel launches per function, and only here,
where they happen; ``zo_perturb_sumsq`` makes two launches per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.dtypes import acc_dtype_of

LAUNCHES = {"zo_perturb_flat": 0, "zo_reconstruct_flat": 0,
            "zo_perturb_sumsq": 0, "zo_reconstruct_update": 0}
_lib_handle = None

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "zo_perturb_flat_launch": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    "zo_reconstruct_flat_launch": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P],
    "zo_sumsq_partials_launch": [_P, _P, _P, _P, _I, _I, _P],
    "zo_perturb_sumsq_apply_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P],
    "zo_reconstruct_update_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _F, _I64, _I,
                                     _I, _I, _I, _P],
}


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels.build import build

        lib = ctypes.CDLL(str(build("zo_direction")))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def _launch(counter: str, entry: str, *args) -> None:
    rc = getattr(_lib(), entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[counter] += 1


def _check(t, what: str, dtype: torch.dtype, device: torch.device, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.data_ptr()


def _scalar(v, device: torch.device) -> torch.Tensor:
    """A float32 (1,) tensor on the card; the kernels read scalars from
    device memory, so a value computed on the card is never synced to the
    host, and a host value is written by a fill kernel, not a blocking copy."""
    if isinstance(v, torch.Tensor) and v.device == device:
        return v.to(torch.float32).reshape(1).contiguous()
    return torch.full((1,), float(v), dtype=torch.float32, device=device)


def _meta(salts, ctrs, nvalid, device, m=None):
    nb = int(ctrs.shape[0])
    if nb < 1:
        raise ValueError("at least one block is required")
    sshape = (nb,) if m is None else (nb, m)
    return (nb,
            _check(salts, "salts", torch.uint32, device, sshape),
            _check(ctrs, "ctrs", torch.uint32, device, (nb,)),
            _check(nvalid, "nvalid", torch.int32, device, (nb,)))


def _cuda_device(t) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors")
    return t.device


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def zo_perturb_flat(x, salts, ctrs, nvalid, scale, block: int = 4096):
    """Whole-buffer ``x + scale * v`` (padding lanes unchanged); one launch."""
    dev = _cuda_device(x)
    nb, ps, pc, pn = _meta(salts, ctrs, nvalid, dev)
    px = _check(x, "x", torch.float32, dev, (nb * block,))
    sc = _scalar(scale, dev)
    out = torch.empty_like(x)
    _launch("zo_perturb_flat", "zo_perturb_flat_launch", px, ps, pc, pn,
            sc.data_ptr(), out.data_ptr(), x.numel(), block, dev.index,
            _stream(dev))
    return out


def zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block: int = 4096,
                        acc_dtype="float32"):
    """Whole-buffer ``sum_w coeffs[w] * v_w``; padding lanes 0; one launch."""
    dev = _cuda_device(ctrs)
    m = int(coeffs.shape[0])
    nb, ps, pc, pn = _meta(salts, ctrs, nvalid, dev, m)
    pco = _check(coeffs, "coeffs", torch.float32, dev, (m,))
    acc_bf16 = int(acc_dtype_of(acc_dtype) == torch.bfloat16)
    out = torch.empty(nb * block, dtype=torch.float32, device=dev)
    _launch("zo_reconstruct_flat", "zo_reconstruct_flat_launch", ps, pco, pc,
            pn, out.data_ptr(), out.numel(), block, m, acc_bf16, dev.index,
            _stream(dev))
    return out


def zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block: int = 4096):
    """``(x + mu*rsqrt(sum v^2)*v, sum v^2)``: two launches, per-block
    partials then a fixed-order reduce inside every block of the apply."""
    dev = _cuda_device(x)
    nb, ps, pc, pn = _meta(salts, ctrs, nvalid, dev)
    px = _check(x, "x", torch.float32, dev, (nb * block,))
    mu_t = _scalar(mu, dev)
    partials = torch.empty(nb, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    ss = torch.empty(1, dtype=torch.float32, device=dev)
    stream = _stream(dev)
    _launch("zo_perturb_sumsq", "zo_sumsq_partials_launch", ps, pc, pn,
            partials.data_ptr(), nb, dev.index, stream)
    _launch("zo_perturb_sumsq", "zo_perturb_sumsq_apply_launch", px, ps, pc,
            pn, partials.data_ptr(), nb, mu_t.data_ptr(), out.data_ptr(),
            ss.data_ptr(), block, dev.index, stream)
    return out, ss


def zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs, lr,
                          momentum: float = 0.0, block: int = 4096,
                          acc_dtype="float32"):
    """Fused reconstruct + SGD(+momentum) commit, IN PLACE on ``p`` (and
    ``mom``); returns ``(p, mom)``.  The caller owns both buffers: no tree
    visible to a user may alias them (FlatEngine packs a fresh copy)."""
    dev = _cuda_device(p)
    m = int(coeffs.shape[0])
    nb, ps, pc, pn = _meta(salts, ctrs, nvalid, dev, m)
    pp = _check(p, "p", torch.float32, dev, (nb * block,))
    pm = None if mom is None else _check(mom, "mom", torch.float32, dev, (nb * block,))
    pb = _check(bf16_mask, "bf16_mask", torch.int32, dev, (nb,))
    pco = _check(coeffs, "coeffs", torch.float32, dev, (m,))
    lr_t = _scalar(lr, dev)
    acc_bf16 = int(acc_dtype_of(acc_dtype) == torch.bfloat16)
    _launch("zo_reconstruct_update", "zo_reconstruct_update_launch", pp, pm,
            ps, pc, pn, pb, pco, lr_t.data_ptr(), float(momentum), p.numel(),
            block, m, acc_bf16, dev.index, _stream(dev))
    return p, mom
