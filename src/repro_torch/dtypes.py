"""Accumulator dtypes by name, as the JAX package spells them."""
from __future__ import annotations

import torch

ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def acc_dtype_of(acc_dtype) -> torch.dtype:
    """'float32' / 'bfloat16' (or the torch dtype itself) -> torch dtype."""
    if isinstance(acc_dtype, torch.dtype):
        if acc_dtype not in ACC_DTYPES.values():
            raise ValueError(f"unsupported accumulator dtype {acc_dtype}")
        return acc_dtype
    try:
        return ACC_DTYPES[str(acc_dtype)]
    except KeyError:
        raise ValueError(f"unsupported accumulator dtype {acc_dtype!r}; "
                         f"have {sorted(ACC_DTYPES)}") from None
