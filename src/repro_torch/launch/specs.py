"""Shape-only input stand-ins and their placements for every (arch x shape).

Counterpart of ``repro.launch.specs``.  The reference's stand-ins are
``jax.ShapeDtypeStruct``s; here they are tensors of the ``meta`` device: a
shape and a dtype, no data, no allocation.  ``init_model`` draws its leaves
on the generator's device (the CPU), so ``abstract_params`` runs it under a
``FakeTensorMode`` (``torch._subclasses.fake_tensor``), which allocates
nothing either, and hands back meta tensors of the same shapes and dtypes.
Leaves flatten in ``jax.tree.leaves`` order (``repro_torch.tree``).

Decode shapes include the full-length caches (attention's k and v, an SSM's
states; with ``shards`` a rank's slices of them); ``long_500k`` shards the
cache's sequence over the worker axes (batch 1; a sequence-sharded
``shards`` gives a rank's rows).  The placements are the port's
``dist.sharding`` specs, the reference's rules.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import stand_ins
from repro_torch.dist.sharding import (
    PartitionSpec, batch_specs, cache_specs, n_workers, param_specs, worker_axes)
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

#: where the stand-ins live: ``meta`` takes every operation a CUDA tensor
#: takes, also in a build of PyTorch without CUDA
DEVICE = "meta"


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=DEVICE)


def abstract_params(cfg: ModelConfig, shard=None) -> Any:
    """``init_model``'s tree as meta tensors (``shard``: this rank's part of
    every leaf, a ``dist.sharding.Sharder``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with stand_ins():
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = T.init_model(0, cfg, device=DEVICE, shard=shard)
        return tree_map(lambda x: _struct(x.shape, x.dtype), fake)


def train_batch_structs(cfg: ModelConfig, shape: ShapeConfig,
                        with_labels: bool = True) -> Dict[str, torch.Tensor]:
    """The global batch: audio features, or tokens (after the image
    embeddings of a vision model, whose labels are -1 over the patches)."""
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        b = {"features": _struct((B, S, cfg.d_model), act)}
        if with_labels:
            b["labels"] = _struct((B, S), torch.int32)
        return b
    if cfg.frontend == "vision":
        Pn = cfg.n_patches
        assert S > Pn, (S, Pn)
        b = {"tokens": _struct((B, S - Pn), torch.int32),
             "image_embeds": _struct((B, Pn, cfg.d_model), act)}
        if with_labels:
            b["labels"] = _struct((B, S), torch.int32)   # -1 over the patch prefix
        return b
    b = {"tokens": _struct((B, S), torch.int32)}
    if with_labels:
        b["labels"] = _struct((B, S), torch.int32)
    return b


def decode_structs(cfg: ModelConfig, shape: ShapeConfig, batch: int = 0, shards=None
                   ) -> Tuple[torch.Tensor, int, Dict]:
    """``(token, pos, caches)``: one token per row, the last position of the
    full-length caches (``pos`` is a Python int, as ``serve_step`` takes it;
    the reference's is a 0-d int32 struct), the caches of ``init_caches``.
    ``batch`` overrides the global batch (a rank's rows), ``shards`` (a
    ``dist.sharding.ShardedParams``) gives this rank's slices of the caches:
    with ``shards.seq`` (``long_500k``) k and v hold the rank's ``S / m``
    rows of the sequence."""
    B, S = batch or shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    with stand_ins():
        caches = T.init_caches(cfg, B, S, act, device=DEVICE, shards=shards)
        return _struct((B,), torch.int32), S - 1, caches


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, kind: str) -> Tuple[Tuple, Tuple]:
    """``(stand-ins, placements)`` for the step kind, the placements as
    ``PartitionSpec`` trees:

    * ``'train'``: ``(t, params, opt_state, batch)``
    * ``'prefill'``: ``(params, batch)``
    * ``'decode'``: ``(params, token, pos, caches)``
    """
    params = abstract_params(cfg)
    pspecs = param_specs(cfg, params, mesh)
    repl = PartitionSpec()
    if kind == "train":
        batch = train_batch_structs(cfg, shape)
        return (0, params, (), batch), (repl, pspecs, (), batch_specs(mesh, batch))
    if kind == "prefill":
        batch = train_batch_structs(cfg, shape, with_labels=cfg.encoder_only)
        return (params, batch), (pspecs, batch_specs(mesh, batch))
    if kind == "decode":
        token, pos, caches = decode_structs(cfg, shape)
        csh = cache_specs(cfg, mesh, caches, seq_sharded=shape.name == "long_500k")
        tok = (repl if shape.global_batch % n_workers(mesh) else
               PartitionSpec(worker_axes(mesh)))
        return (params, token, pos, caches), (pspecs, tok, repl, csh)
    raise ValueError(kind)
