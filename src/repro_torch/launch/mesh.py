"""Meshes over a ``torch.distributed`` process group, and ranks to run on them.

Counterpart of ``repro.launch.mesh``: the same shapes and axis names, as a
``DeviceMesh`` over the process group that the caller initialised (one rank
per mesh position).  Nothing here touches device or group state at import.

The reference's ``HW`` table (its chip's peak rates) has no counterpart here:
the dry run (``launch.dryrun``) prices memory and operations, not time.

``process_group`` gives a caller without a group (the trainer and the
simulator in one process) a world-size-1 gloo group for its 1x1 mesh.
``init_rank`` and ``spawn_ranks`` run a function on m local ranks, each in a
process of its own: the group is initialised from a ``file://`` store (no
port to pick), every rank is joined with a timeout, and a rank that raises,
exits non-zero or does not finish in time fails the whole run.  On one card
every rank's tensors sit on ``cuda:0`` and the group is gloo: NCCL takes one
GPU per rank.
"""
from __future__ import annotations

import contextlib
import math
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, List

import torch

from repro_torch.device import resolve_device


def _mesh(shape, names, device) -> "torch.distributed.device_mesh.DeviceMesh":
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs an initialised torch.distributed "
                           "process group (init_rank, or init_process_group)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """One pod of 16 x 16 ranks, or 2 pods = 512: ``("data", "model")`` or
    ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(data: int = 4, model: int = 2, pod: int = 0, *, device="cuda"):
    """Small mesh: ``(data, model)``, or ``(pod, data, model)`` when ``pod``."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)


# --------------------------------------------------------------------------- #
# local ranks
# --------------------------------------------------------------------------- #
def init_rank(rank: int, world_size: int, init_file: str) -> None:
    """Join the gloo group of ``world_size`` ranks that meet at
    ``init_file`` (a path that no earlier group used)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size)


@contextlib.contextmanager
def process_group() -> Iterator[int]:
    """The caller's process group, or a world-size-1 gloo group over a
    ``file://`` store in a temporary directory, destroyed on exit; yields
    the group's world size."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield dist.get_world_size()
        return
    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, 1, os.path.join(tmp, "init"))
        try:
            yield 1
        finally:
            dist.destroy_process_group()


def _rank_main(fn, rank, world_size, init_file, args, results):
    import torch.distributed as dist

    try:
        init_rank(rank, world_size, init_file)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, world_size: int, init_file: str, *args: Any,
                timeout: float = 300.0) -> List[Any]:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned processes,
    each in the group that meets at ``init_file``; returns their results in
    rank order.  ``fn`` must be importable by the children (a module-level
    function).  Raises when a rank raises, exits non-zero or is not done
    within ``timeout`` seconds (the rest are then terminated)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, init_file, args,
                                                  results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before joining: a child blocks until its result is read
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))} "
                                   f"did not finish within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for r, p in enumerate(procs):
            p.join(max(1.0, deadline - time.monotonic()))
            if p.is_alive() or p.exitcode != 0:
                raise RuntimeError(f"rank {r} did not exit cleanly (exit code {p.exitcode})")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        results.close()
    return [got[r] for r in range(world_size)]

