"""What every ctypes-bound CUDA library of the port shares.

A library is built (``kernels.build``) and loaded at its first launch, never
at import.  Each C entry point launches one kernel on PyTorch's current
stream and returns ``cudaGetLastError()``; ``launch`` raises when that is not
0 and counts the launch only when it was accepted.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple, Union

import torch

_LIBS: Dict[str, ctypes.CDLL] = {}


def library(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use) with the argument
    types of its entry points set: a pointer must be ``c_void_p``, or ctypes
    passes a 32-bit int and cuts it."""
    lib = _LIBS.get(name)
    if lib is None:
        from repro_torch.kernels.build import build

        lib = ctypes.CDLL(str(build(name)))
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch(lib: ctypes.CDLL, counts: Dict[str, int], counter: Union[str, Tuple[str, ...]],
           entry: str, *args) -> None:
    """Call ``entry``; on success add one to ``counts[counter]`` (to each
    name, when ``counter`` is a tuple)."""
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error {rc}")
    for name in (counter,) if isinstance(counter, str) else counter:
        counts[name] += 1


def check(t, what: str, dtype: torch.dtype, device: torch.device, shape=None) -> int:
    """``t.data_ptr()`` after checking type, device, dtype, contiguity and
    (when given) shape; raises on anything else."""
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


def cuda_device(t) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors")
    return t.device


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
