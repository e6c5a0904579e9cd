"""Device selection for the port's entry points.

The default device is the GPU.  Without one, an entry point raises instead
of quietly running on the CPU; the CPU path (the kernels' plain versions) is
taken only when the caller asks for it with ``device="cpu"``.

The dry run (``launch.dryrun``) runs its steps on tensors of the ``meta``
device (a shape and a dtype, no data): ``resolve_device`` takes ``"meta"``
only inside ``stand_ins()``, which no real run enters.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch


_STAND_INS = [False]


@contextlib.contextmanager
def stand_ins() -> Iterator[None]:
    """A block in which entry points may make their tensors on ``meta``."""
    saved, _STAND_INS[0] = _STAND_INS[0], True
    try:
        yield
    finally:
        _STAND_INS[0] = saved


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent.

    On the card, TF32 is switched off for matrix products and cuDNN so that
    float32 products run in full float32, as the JAX reference computes them.
    ``"meta"`` is taken inside ``stand_ins()`` only (the module docstring).
    """
    dev = torch.device(device)
    if dev.type == "meta" and _STAND_INS[0]:
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on the card through pinned memory and a
    non-blocking copy, so the host does not wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
