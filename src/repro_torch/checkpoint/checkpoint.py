"""Pytree checkpointing: an npz payload and a msgpack manifest.

Counterpart of ``repro.checkpoint.checkpoint``, in the same on-disk format,
so a checkpoint written by either package restores in the other: atomic
``step_%08d`` directories (written under a ``.tmp_`` directory that is
renamed into place, and removed if the save fails), ``arrays.npz`` with one
array ``a{i}`` per leaf, and ``manifest.msgpack`` with the step, the leaf
names, the logical dtypes and the shapes.

* Leaf names are ``jax.tree_util.keystr`` spellings (``"['embed']"``,
  ``"['layers']['attn']['wq']"``, ``"[0]"``) in ``tree.py``'s leaf order,
  which is JAX's (sorted dict keys).
* Dtypes are numpy's names (``"bfloat16"``, ``"float32"``, ``"int64"``).  A
  bfloat16 leaf, which npz cannot hold, is stored as a float32 payload (the
  widening is exact) and restored to bfloat16.
* Python scalars in the tree (a step counter) are canonicalised through
  numpy, which keeps int64 and float64.
* The manifest is written and read by ``checkpoint.manifest`` (the
  manifest's msgpack subset, byte for byte what ``msgpack.packb`` writes).

Leaves may be tensors on any device or numpy arrays.  ``restore`` returns
tensors (64-bit payloads keep their width) on ``device``, or on the CPU
when ``device`` is None; the reference's ``shardings`` have no counterpart.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manifest as mp
from repro_torch.tree import tree_flatten, tree_unflatten


def _names(treedef, prefix: str = "") -> List[str]:
    """``jax.tree_util.keystr`` of every leaf's path, in leaf order."""
    kind, keys, defs = treedef
    if kind == "leaf":
        return [prefix]
    if kind == "none":
        return []
    if kind == "dict":
        return [n for k, d in zip(keys, defs) for n in _names(d, f"{prefix}[{k!r}]")]
    return [n for i, d in enumerate(defs) for n in _names(d, f"{prefix}[{i}]")]


def _flatten_with_names(tree: Any):
    leaves, treedef = tree_flatten(tree)
    return _names(treedef), leaves, treedef


def _payload(x) -> Tuple[np.ndarray, str]:
    """``(npz array, logical dtype name)`` of one leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.to(torch.float32).cpu().numpy(), "bfloat16"
        x = x.cpu().numpy()
    a = np.asarray(x)          # also Python scalars, as int64 / float64
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32), "bfloat16"
    return a, a.dtype.name


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically save ``tree`` under ``ckpt_dir/step_<step>``."""
    names, leaves, _ = _flatten_with_names(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays, dtypes, shapes = {}, [], []
        for i, x in enumerate(leaves):
            a, dt = _payload(x)
            arrays[f"a{i}"] = a
            dtypes.append(dt)
            shapes.append([int(s) for s in a.shape])
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"step": int(step), "names": names, "dtypes": dtypes, "shapes": shapes}
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(mp.pack(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.startswith(".")]
    return max(steps) if steps else None


def _leaf(a: np.ndarray, dtype: str) -> torch.Tensor:
    # np.array copies into a writable, contiguous array and keeps a 0-d shape
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, np.dtype(dtype)))


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            device=None) -> Tuple[Any, int]:
    """``(tree, step)``: the checkpoint at ``step`` (default the latest) in
    the structure of ``like``, as tensors of the manifest's dtypes on
    ``device`` (the CPU when None).  Raises ``ValueError`` when the leaf
    names differ from ``like``'s."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = mp.unpack(f.read())
    names, _, treedef = _flatten_with_names(like)
    if names != manifest["names"]:
        raise ValueError(
            f"checkpoint tree mismatch:\n saved={manifest['names'][:5]}...\n"
            f" expected={names[:5]}..."
        )
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [_leaf(data[f"a{i}"], dt) for i, dt in enumerate(manifest["dtypes"])]
    if device is not None:
        leaves = [x.to(device) for x in leaves]
    return tree_unflatten(treedef, leaves), manifest["step"]
