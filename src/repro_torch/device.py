"""Device selection for the port's entry points.

The default device is the GPU.  Without one, an entry point raises instead
of quietly running on the CPU; the CPU path (the kernels' plain versions) is
taken only when the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent.

    On the card, TF32 is switched off for matrix products and cuDNN so that
    float32 products run in full float32, as the JAX reference computes them.
    """
    dev = torch.device(device)
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
