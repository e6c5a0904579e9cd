"""Device pipeline: each rank's rows of the host batches, with a prefetch queue.

Counterpart of ``repro.data.pipeline``.  The reference places a whole host
batch on the mesh (``jax.device_put`` with ``batch_specs``); here every rank
is a process of its own, so ``shard_batches`` yields this rank's part of every
host batch: for a leaf that ``batch_specs`` shards over the worker axes, the
rows of this rank's worker (worker w of m owns rows ``[w*n/m, (w+1)*n/m)``,
the reference's block layout); a replicated leaf whole.  Ranks that differ
only on the ``model`` axis get the same rows.  Under ``fsdp`` a worker is
the whole data x model slice, and ``whole=True`` gives every rank every row.
The rows go to the mesh's device through pinned memory with non-blocking
copies, ``prefetch`` batches ahead.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.dist.sharding import PartitionSpec, batch_specs, n_workers, worker_index
from repro_torch.tree import tree_map


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batches(host_batches: Iterator[Any], mesh, prefetch: int = 2,
                  whole: bool = False) -> Iterator[Any]:
    """This rank's rows of every host batch (every row with ``whole``) on
    the mesh's device, copied ``prefetch`` batches ahead of the consumer."""
    dev = _mesh_device(mesh)
    w, m = (0, 1) if whole else (worker_index(mesh), n_workers(mesh))

    def rows(x, spec: PartitionSpec):
        if len(spec):                   # leading dim over the worker axes
            per = x.shape[0] // m
            x = x[w * per:(w + 1) * per]
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.to(dev)
        return host_to_device(np.asarray(x), dev)

    def put(batch):
        return tree_map(rows, batch, batch_specs(mesh, batch))

    queue: deque = deque()
    it = iter(host_batches)
    for b in itertools.islice(it, prefetch):
        queue.append(put(b))
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out


def take(it: Iterator[Any], n: int):
    return itertools.islice(it, n)
