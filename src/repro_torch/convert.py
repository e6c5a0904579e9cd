"""Carry parameter and optimizer-state trees between numpy and the port.

A JAX run's parameters (or its SGD momentum / Adam moments, which are trees
of the same structure) become tensors with ``params_from_numpy(tree)``, so a
run started in the JAX package continues in the port: ``np.asarray`` of a
JAX array is the bridge, and no JAX import is needed here.  bfloat16 arrays
(numpy's ``ml_dtypes`` bfloat16) are carried bit for bit.  A transformer's
``init_model`` tree needs nothing more: its layers are stacked on axis 0 in
both packages, and its nested dicts flatten in the same sorted-key order.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def _to_tensor(x) -> torch.Tensor:
    a = np.array(x)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Tree of arrays -> same tree of tensors on ``device``.

    Works for any tree: parameters, momentum trees, Adam's ``(mu, nu)``
    pair, an empty ``()`` state.  ``dtype`` casts floating leaves; None keeps
    each leaf's dtype.  Python scalars in the tree (counters) stay as they are.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, (int, float)):
            return x
        # a copy either way: the result never aliases the caller's buffer
        t = x.detach().clone() if isinstance(x, torch.Tensor) else _to_tensor(x)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(conv, tree)


def tree_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> tree of numpy arrays (bfloat16 leaves as float32)."""
    def conv(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()

    return tree_map(conv, tree)
