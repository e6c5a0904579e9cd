"""Distributed HO-SGD, in PyTorch: the round IR lowered onto a process group.

Counterpart of ``repro.core.distributed``.  The method is defined once in
``core.rounds`` (``fo_round`` / ``zo_round``); this module lowers those
rounds to a mesh (``launch.mesh``) in one of three formulations, picked from
the mesh as the reference picks its own:

* **One process holding the m workers** (the mesh's worker axes span one
  rank; ``m`` says how many workers the process simulates): the reference's
  auto-sharded branch.  The ZO step runs the m coefficient evaluations in the
  process through ``core.ho_sgd``'s round functions (``zo_round_estimate``;
  with ``engine="flat"``, plain SGD and no specs, ``fused_flat_zo_round``:
  ``zo_perturb_sumsq`` per worker and one in-place ``zo_reconstruct_update``),
  the FO step takes the gradient of the batch mean, and both book their
  exchanges with ``dist.collectives.note``.
* **One rank per worker** (the worker axes span m > 1 ranks): the
  reference's manual ``shard_map`` branch.  Each rank holds its own shard
  of the batch (``data.pipeline.shard_batches``) and a replica of the
  parameters.  The ZO step computes the rank's own coefficient under its
  worker id (``pod_idx * n_data + data_idx``), all-gathers one float32 scalar
  per rank (4·m bytes) and reconstructs all m directions on every rank,
  through the generic reconstruct-then-``opt.update`` path; the FO step
  all-reduces the local gradient's mean (4·d bytes).  The monitoring loss is
  a ``pmean`` booked ``payload=False``.
* **fsdp** (one global direction, m = 1): ``zo_single``, booked as 4 bytes;
  the FO step is the one-process formulation (the whole mesh is one worker).
* **A MoE model on several worker ranks** (``whole_batch``; fsdp off): every
  rank receives the global batch (``takes_whole_batch``).  The uncompressed
  and ``legacy`` FO steps are the one-process formulation on every rank, the
  gradient of the global batch: a MoE layer's capacity (T = B·S of the batch
  it routes) and its load-balance loss are the global batch's, as in the
  reference's ``value_and_grad`` over its batch.  Every rank then holds the
  same gradient, so nothing is all-reduced; the exchange is booked as the
  one-process step books it (4·d).  The cost is m times the FO compute.
  The ZO step and the ``per_worker`` codec cut the rank's worker's rows
  (``data.pipeline.worker_rows``) and run as one rank per worker, as the
  reference's ``shard_map`` and per-worker ``vmap`` take each worker's rows.

FO wire codecs: ``compress_mode="per_worker"`` encodes every worker's
gradient with its own key (``fold(fold(seed, t), w)``) and is booked at
``nbytes`` x m; ``"legacy"`` encodes the mean (key ``fold(seed, t)``) and is
booked at one worker's ``nbytes``; ``grad_accum > 1`` falls back to legacy
with a warning.  On the process group the codes' exchange is carried as a
mean of the decoded gradients (the same values every worker gets by
decoding every code), booked at the codes' bytes, as the reference books the
reduction its partitioner inserts; the dense mean also appears in the ledger
as a ``payload=False`` ``pmean``.

Sharded placements (``param_specs_tree``: the reference's ``param_specs``,
tensor-parallel over ``model`` and, under ``fsdp``, over ``data``): each
rank holds its shard of every parameter, of the optimizer state and of
every direction buffer; the ``model`` axis partitions the forward by
Megatron's convention and the other axes are storage, gathered just before
use (``dist.sharding.ShardedParams``; the caller's ``loss_fn`` runs it, as
the trainer's does).  The loss, and so f0 and f1, is the same scalar on
every rank of a worker (the partitioned forward's all-reduces sum in rank
order).  The engines run on the shards with global counters, the global d
and the global norm (``core.engine``); the ZO exchange stays one float32
scalar per worker rank (4·m); the FO gradient of a ``model``-cut leaf is
computed on the rank's shard, a replicated leaf's is the same on every rank
of the axis, and both are averaged over the worker axes; codecs work on
shards.  Under ``fsdp`` a worker is the whole data x model slice (the
reference's config: its ZO step runs m = 1, and its products are the
global batch's): every rank takes the whole batch
(``data.pipeline.shard_batches(..., whole=True)``) and runs the one-process
formulation on its shards, so a MoE layer's capacity and load-balance loss
are the global batch's, as in the reference.  Every exchange is booked at the
GLOBAL tree's bytes (4·d FO, per-worker codec ``nbytes`` of the global
leaves x m), as the reference's traced global shapes book it, never at a
shard's; the partitioned forward's all-reduces are the model's internal
traffic and are counted apart (``collectives.REDUCES``), not booked.  The
fused flat round stays off under specs (it scales by its own buffer's
norm).  The reference's own placement hints (its engine's ``_constrain``)
have no counterpart: nothing is compiled.

What differs from the reference: a row-parallel product's partials are
float32 and summed in rank order, rounded once (the reference's compiler
sums what it chooses).  ``scan_unroll`` and ``buckets`` have no meaning in
eager PyTorch and are accepted for the signature: the reference chunks its
flat gradient into ``buckets`` so that its compiler may overlap each
chunk's reduction with compute, with the same values and bytes; eager
PyTorch has nothing to overlap, so every ``buckets`` runs the one
reduction.
``jit_with_shardings`` has no counterpart: nothing is compiled.  Steps run
eagerly; a batch may be numpy arrays or tensors and is moved to the
parameters' device.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Callable, Optional

import torch

from repro_torch.core import directions as D
from repro_torch.core import rounds
from repro_torch.core.ho_sgd import (
    HOSGDConfig, _device_of, engine_cache, fused_flat_zo_round, to_device,
    value_and_grad, zo_estimate, zo_round_estimate)
from repro_torch.data.pipeline import worker_rows
from repro_torch.dist import collectives as coll
from repro_torch.dist.compress import Compressor, compress_tree
from repro_torch.dist.sharding import (
    ShardGeometry, mesh_shape, n_workers, param_specs, spec_axes, worker_axes,
    worker_index)
from repro_torch.opt.optimizers import Optimizer, apply_deltas, const_schedule, sgd
from repro_torch.tree import tree_leaves, tree_map

_F32 = torch.float32


def _split(batch: Any, m: int) -> Any:
    """(m*B, ...) -> (m, B, ...) on every leaf."""
    for x in tree_leaves(batch):
        if x.shape[0] % m:
            raise ValueError(f"batch {tuple(x.shape)} not divisible by m={m} workers")
    return tree_map(lambda x: x.reshape(m, x.shape[0] // m, *x.shape[1:]), batch)


def _cuts(specs: Any, mesh) -> bool:
    """Whether a spec of ``specs`` cuts a leaf over an axis of more than one
    rank."""
    if specs is None:
        return False
    shape = mesh_shape(mesh)
    return any(shape[a] > 1 for spec in tree_leaves(specs) for part in spec
               for a in spec_axes(part))


def _geometry_cache(specs: Any, mesh) -> Callable:
    """``params -> ShardGeometry`` of this rank's shards, or None when no
    spec cuts a leaf over an axis of more than one rank."""
    cache: dict = {}

    def geometry_of(params):
        if not _cuts(specs, mesh):
            return None
        key = tuple(tuple(x.shape) for x in tree_leaves(params))
        if key not in cache:
            cache[key] = ShardGeometry.from_local(specs, params, mesh)
        return cache[key]

    return geometry_of


def _codec_nbytes(compressor: Compressor, geom: ShardGeometry) -> int:
    """The codec's wire bytes for the GLOBAL tree (``compress_tree``'s sum)."""
    return sum(compressor.nbytes(math.prod(s)) for s in geom.shapes)


def make_fo_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    mesh,
    opt: Optimizer,
    grad_accum: int = 1,
    scan_unroll: bool = False,
    compressor: Optional[Compressor] = None,
    seed: int = 0,
    compress_mode: str = "per_worker",
    m: Optional[int] = None,
    buckets: int = 1,
    param_specs_tree: Any = None,
    fsdp: bool = False,
    whole_batch: bool = False,
) -> Callable:
    """``(t, params, opt_state, batch) -> (params, opt_state, loss)``: the FO
    round (eq. 3) lowered to ``mesh``.  ``grad_accum`` splits the batch into
    microbatches (row i of every ``grad_accum`` rows goes to microbatch i)
    with a float32 gradient accumulator; ``compressor``/``compress_mode``
    hook a codec onto the gradient exchange; ``m`` defaults to the mesh's
    worker count; ``buckets`` has no effect (the module docstring);
    ``param_specs_tree`` places the parameters (``params`` are then this
    rank's shards); ``fsdp`` makes the whole mesh one worker;
    ``whole_batch`` says every rank receives the global batch (a MoE model,
    the module docstring)."""
    rnd = rounds.fo_round(loss_fn, opt, wire=rounds.Wire(compressor, compress_mode),
                          overlap=rounds.Overlap(buckets))
    return lower_fo_round(rnd, mesh, grad_accum=grad_accum, scan_unroll=scan_unroll,
                          seed=seed, m=m, param_specs_tree=param_specs_tree, fsdp=fsdp,
                          whole_batch=whole_batch)


def lower_fo_round(
    rnd: rounds.Round,
    mesh,
    *,
    grad_accum: int = 1,
    scan_unroll: bool = False,
    seed: int = 0,
    m: Optional[int] = None,
    param_specs_tree: Any = None,
    fsdp: bool = False,
    whole_batch: bool = False,
) -> Callable:
    """An FO round's per-worker gradients + all-reduce + apply as one step:
    in one process the gradient of the batch mean, booked with
    ``note_all_reduce``; on a process group each rank's gradient, all-reduced
    over the worker axes.  Under sharded specs each rank's gradient is its
    shard's, and the exchange is booked at the global tree's bytes; under
    ``fsdp``, and with ``whole_batch`` but for the ``per_worker`` codec,
    every rank runs the one-process formulation on the global batch."""
    loss_fn, opt = rnd.meta["loss_fn"], rnd.meta["opt"]
    compressor, mode = rnd.wire.codec, rnd.wire.mode
    wa = worker_axes(mesh)
    ranks = 1 if fsdp else n_workers(mesh)
    m = m if m is not None else max(1, ranks)
    if ranks > 1 and m != ranks:
        raise ValueError(f"a mesh of {ranks} worker ranks runs one worker per rank; "
                         f"got m={m}")
    geometry_of = _geometry_cache(param_specs_tree, mesh)
    per_worker = compressor is not None and mode == "per_worker" and m > 1
    if per_worker and grad_accum > 1:
        # per-worker encoding needs the m gradients apart, which the
        # microbatch accumulator collapses: fall back to the legacy codec
        warnings.warn(
            "per-worker FO encoding does not compose with grad_accum > 1; "
            "falling back to compress_mode='legacy' (post-reduction codec)",
            stacklevel=2)
        per_worker = False

    def grad_of(params, batch):
        if grad_accum <= 1:
            return value_and_grad(loss_fn, params, batch)
        mb = tree_map(lambda x: x.reshape(x.shape[0] // grad_accum, grad_accum,
                                          *x.shape[1:]).transpose(0, 1), batch)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device),
                         params)
        l_acc = torch.zeros((), dtype=_F32, device=_device_of(params))
        for i in range(grad_accum):
            loss, g = value_and_grad(loss_fn, params, tree_map(lambda x: x[i], mb))
            g_acc = tree_map(lambda a, gg: a + gg.to(_F32), g_acc, g)
            l_acc = l_acc + loss
        return l_acc / grad_accum, tree_map(lambda g: g / grad_accum, g_acc)

    def wire_of(geom, nb):
        """A codec's booked bytes: the global tree's when sharded."""
        return nb if geom is None else _codec_nbytes(compressor, geom)

    def one_process(t, params, batch):
        geom = geometry_of(params)
        if per_worker:
            # each worker's shard gradient encoded with its own key and
            # decoded at the reducer: every worker receives m codes
            key_t, stacked = D.fold(seed, t), _split(batch, m)
            losses, dec, wire = [], [], 0
            for w in range(m):
                loss, g = value_and_grad(loss_fn, params, tree_map(lambda x: x[w], stacked))
                d_w, nb = compress_tree(compressor, g, D.fold(key_t, w))
                losses.append(loss)
                dec.append(d_w)
                wire = wire_of(geom, nb) * m
            grads = tree_map(lambda *xs: torch.mean(torch.stack(
                [x.to(_F32) for x in xs]), 0).to(xs[0].dtype), *dec)
            coll.note_all_reduce(grads, nbytes=wire, tag=compressor.name)
            return torch.mean(torch.stack(losses)), grads
        loss, grads = grad_of(params, batch)
        if compressor is not None:
            grads, wire = compress_tree(compressor, grads, D.fold(seed, t))
            coll.note_all_reduce(grads, nbytes=wire_of(geom, wire), tag=compressor.name)
        else:
            coll.note_all_reduce(grads, tag="grads", nbytes=None if geom is None
                                 else geom.global_nbytes(grads))
        return loss, grads

    def rank_per_worker(t, params, batch):
        geom = geometry_of(params)
        loss, grads = grad_of(params, batch)
        loss = coll.pmean(loss, wa, mesh=mesh, tag="loss", payload=False)
        if compressor is None:
            return loss, coll.pmean(grads, wa, mesh=mesh, tag="grads", nbytes=None
                                    if geom is None else geom.global_nbytes(grads))
        if per_worker:
            dec, nb = compress_tree(compressor, grads,
                                    D.fold(D.fold(seed, t), worker_index(mesh)))
            grads = coll.pmean(dec, wa, mesh=mesh, tag="decoded", payload=False)
            wire = wire_of(geom, nb) * m
        else:
            grads = coll.pmean(grads, wa, mesh=mesh, tag="decoded", payload=False)
            grads, wire = compress_tree(compressor, grads, D.fold(seed, t))
            wire = wire_of(geom, wire)
        coll.note_all_reduce(grads, nbytes=wire, tag=compressor.name)
        return loss, grads

    def fo_step(t, params, opt_state, batch):
        batch = to_device(batch, _device_of(params))
        if ranks == 1 or (whole_batch and not per_worker):
            loss, grads = one_process(t, params, batch)
        else:
            loss, grads = rank_per_worker(t, params, worker_rows(batch, mesh)
                                          if whole_batch else batch)
        with torch.no_grad():
            deltas, opt_state = opt.update(grads, opt_state, params, t)
            return apply_deltas(params, deltas), opt_state, loss

    return fo_step


def make_zo_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    mesh,
    ho: HOSGDConfig,
    opt: Optimizer,
    m: Optional[int] = None,
    fsdp: bool = False,
    param_specs_tree: Any = None,
    vmap_workers: bool = False,
    whole_batch: bool = False,
) -> Callable:
    """``(t, params, opt_state, batch) -> (params, opt_state, loss)``: the ZO
    round (eq. 4-6) lowered to ``mesh``.  The reconstructed estimate is
    handed to ``opt.update``, so any optimizer composes (the fused flat
    round excepted, which commits plain SGD in its kernel).  ``fsdp`` runs
    the m = 1 step (one global direction); with ``whole_batch`` each rank
    of several worker ranks cuts its worker's rows from the global batch."""
    rnd = rounds.zo_round(loss_fn, ho, opt, m=m)
    return lower_zo_round(rnd, mesh, m=m, fsdp=fsdp, param_specs_tree=param_specs_tree,
                          vmap_workers=vmap_workers, whole_batch=whole_batch)


def lower_zo_round(
    rnd: rounds.Round,
    mesh,
    *,
    m: Optional[int] = None,
    fsdp: bool = False,
    param_specs_tree: Any = None,
    vmap_workers: bool = False,
    whole_batch: bool = False,
) -> Callable:
    """A ZO round's per-worker coefficients + scalar all-gather +
    reconstruction as one step, in the formulation the mesh calls for (the
    module docstring)."""
    loss_fn, ho, opt = rnd.meta["loss_fn"], rnd.meta["ho"], rnd.meta["opt"]
    wa = () if fsdp else worker_axes(mesh)
    ranks = 1 if fsdp else n_workers(mesh)
    m = m or max(1, ranks)
    if ranks > 1 and m != ranks:
        raise ValueError(f"a mesh of {ranks} worker ranks runs one worker per rank; "
                         f"got m={m}")
    sharded = _cuts(param_specs_tree, mesh)
    engine_for = engine_cache(ho.engine, ho.seed, ho.acc_dtype,
                              specs=param_specs_tree if sharded else None, mesh=mesh)

    def zo_inner(t, params, batch):
        """One rank per worker: this rank's coefficient, the m scalars
        all-gathered, every direction rebuilt here."""
        eng = engine_for(params)
        c, f0 = eng.zo_coeff(loss_fn, params, batch, t, worker_index(mesh), ho.mu)
        cs = coll.all_gather(c, wa, mesh=mesh, tag="zo_coeffs").reshape(-1)
        g_hat = zo_estimate(eng, cs, t, ho.zo_scale)
        # averaging the monitoring loss is diagnostics, not Algorithm 1's
        # communication: booked as non-payload so the bytes stay 4*m
        loss = coll.pmean(f0, wa, mesh=mesh, tag="loss", payload=False)
        return g_hat, loss

    def zo_single(t, params, batch):
        """m = 1 (fsdp): one global direction, a one-scalar gather booked
        as 4 bytes; every rank of the mesh holds the whole batch."""
        eng = engine_for(params)
        c, f0 = eng.zo_coeff(loss_fn, params, batch, t, 0, ho.mu)
        cs = coll.note("all_gather", c.reshape(1), tag="zo_coeffs")
        return zo_estimate(eng, cs, t, ho.zo_scale), f0

    def booked(cs, loss):
        """One process, m workers: the coefficient exchange and the
        monitoring loss's mean, booked as the group would run them."""
        return (coll.note("all_gather", cs, tag="zo_coeffs"),
                coll.note("pmean", loss, tag="loss", payload=False))

    # the fused single-buffer round: engine='flat' + plain SGD + no specs in
    # one process (the kernels commit in place on this process's buffer and
    # scale by its own norm; a process group and sharded specs keep the
    # generic reconstruct-then-opt.update path)
    fused_flat = ho.engine == "flat" and opt.kind == "sgd" and param_specs_tree is None
    workers = list(range(m))

    @torch.no_grad()
    def zo_step(t, params, opt_state, batch):
        batch = to_device(batch, _device_of(params))
        if not wa:
            g_hat, loss = zo_single(t, params, batch)
        elif ranks == 1:
            eng = engine_for(params)
            if fused_flat:
                return fused_flat_zo_round(eng, loss_fn, opt, t, params, opt_state,
                                           _split(batch, m), workers, ho.mu, ho.zo_scale,
                                           exchange=booked)
            g_hat, loss = zo_round_estimate(eng, loss_fn, params, _split(batch, m), t,
                                            workers, ho.mu, ho.zo_scale, exchange=booked,
                                            vmap_workers=vmap_workers)
        else:
            g_hat, loss = zo_inner(t, params, worker_rows(batch, mesh) if whole_batch
                                   else batch)
        deltas, opt_state = opt.update(g_hat, opt_state, params, t)
        return apply_deltas(params, deltas), opt_state, loss

    return zo_step


def make_distributed_ho_sgd(
    loss_fn: Callable,
    mesh,
    ho: HOSGDConfig,
    opt: Optional[Optimizer] = None,
    model_cfg=None,
    params_like: Any = None,
    compressor: Optional[Compressor] = None,
    vmap_workers: bool = False,
    compress_mode: str = "per_worker",
    fo_buckets: int = 1,
):
    """``(fo_step, zo_step)`` honouring the config's knobs (``grad_accum``,
    ``fsdp``; the parameter specs when ``model_cfg`` and ``params_like`` are
    given: ``params_like`` has the GLOBAL shapes, a whole tree or meta
    tensors of it, and when a spec cuts a leaf over an axis of more than one
    rank the steps take and return this rank's shards, ``loss_fn`` running
    the partitioned forward on them).  ``compressor`` quantizes the FO gradient exchange; the ZO step's
    traffic is already one scalar per worker.  The worker count is
    ``ho.m``: one process holds all of them when the mesh's worker axes span
    one rank, and a group must have ``ho.m`` worker ranks (``ValueError``
    otherwise); ``fsdp`` runs m = 1, the whole mesh one worker that takes the
    whole batch on every rank.  A MoE model takes the global batch on every
    rank too (``takes_whole_batch``; the module docstring)."""
    opt = opt or sgd(const_schedule(ho.lr), ho.momentum)
    ga = getattr(model_cfg, "grad_accum", 1) if model_cfg is not None else 1
    su = getattr(model_cfg, "scan_unroll", False) if model_cfg is not None else False
    fsdp = getattr(model_cfg, "fsdp", False) if model_cfg is not None else False
    specs = None
    if model_cfg is not None and params_like is not None:
        specs = param_specs(model_cfg, params_like, mesh)
    whole = takes_whole_batch(model_cfg) and not fsdp
    fo = make_fo_step(loss_fn, mesh, opt, grad_accum=ga, scan_unroll=su,
                      compressor=compressor, seed=ho.seed, compress_mode=compress_mode,
                      m=ho.m, buckets=fo_buckets, param_specs_tree=specs, fsdp=fsdp,
                      whole_batch=whole)
    zo = make_zo_step(loss_fn, mesh, ho, opt, m=1 if fsdp else ho.m, fsdp=fsdp,
                      param_specs_tree=specs,
                      vmap_workers=vmap_workers, whole_batch=whole)
    return fo, zo


def takes_whole_batch(model_cfg) -> bool:
    """Whether every rank receives the global batch
    (``data.pipeline.shard_batches(..., whole=True)``): under ``fsdp``, and
    for a model with MoE layers, whose FO step takes the global batch."""
    return model_cfg is not None and bool(model_cfg.fsdp or model_cfg.is_moe)
