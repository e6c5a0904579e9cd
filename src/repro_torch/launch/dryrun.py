"""Dry run: one rank's real step on fake tensors, for every (arch x shape x mesh).

Counterpart of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each target for its production mesh, this runs the port's own step
eagerly on tensors of the ``meta`` device (a shape, a dtype, no data;
``launch.specs``) for one rank of that mesh: the process group is
``torch.distributed``'s ``fake`` backend (world size 256, or 512 for the
multi-pod mesh; ``REPRO_TEST_MESH``, e.g. ``2x2`` or ``2x2x2``, gives a small
one), the mesh is ``launch.mesh``'s, and the step is what the port runs:

* ``fo`` / ``zo``: ``core.distributed.make_distributed_ho_sgd`` as the trainer
  builds it (this rank's shards, ``transformer.loss_fn`` partitioned over
  ``model``, the engine ``flat``, SGD), with the reference's dry-run config
  ``HOSGDConfig(tau=8, mu=1e-3, lr=1e-2, zo_lr=1e-8)``, on this rank's rows
  of the global batch (every row for an fsdp or MoE model,
  ``core.distributed.takes_whole_batch``);
* ``prefill``: ``transformer.prefill`` (``forward_logits`` for an
  encoder-only model) and ``decode``: ``serving.engine.serve_step`` at the
  last position of full-length caches, both as the serving CLI runs them on
  the card (``use_pallas``), on this rank's rows (all of them when the
  worker count does not divide the batch), on this rank's shards
  partitioned over ``model`` (``dist.sharding.ShardedParams``) and its
  slices of the caches (``init_caches(..., shards=)``: ``cache_specs``'
  cut over ``model``).  ``long_500k`` (batch 1) also cuts k's and v's
  sequence over the worker axes (``ShardedParams(..., seq_sharded=True)``):
  the rank holds ``S / m`` rows, and each attention layer combines the
  ranks' partial softmaxes over those axes (``axis_worker``).

Each kernel runs through its operator in ``kernels.fake`` (the same dispatch
as on the card).  Every step runs at full depth: an eager run counts every
layer, so the reference's depth extrapolation (``scan_correct``,
``hlo.extrapolate``) has no counterpart.

The record (one JSON a target under ``--out``) keeps the reference's keys
where they mean something here:

* ``params``, ``params_active``, ``model_flops``, ``n_layers``, ``period``,
  ``n_groups``;
* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the step,
  flash attention's operator counted as 4·hd per live (query, key) pair and
  head; ``cost.bytes``: each operation's operand and result bytes, summed
  (views excepted): XLA's "bytes accessed" before fusion;
* ``memory``: ``argument_size_in_bytes`` (what the rank holds when the step
  starts: shards, optimizer state, batch, caches), ``peak_memory_in_bytes``
  (the most device bytes live at once over the step, each allocation
  rounded up to the caching allocator's 512 bytes), ``temp_size_in_bytes``
  (peak minus arguments), ``output_size_in_bytes``;
* ``collectives``: the keys of ``hlo.collective_bytes``, from the
  ``CommLedger``'s booking of the step (the worker exchange: 4·d FO, 4·m
  ZO), the gathers that ``dist.sharding.gather`` made
  (``collectives.GATHERS``: their results' bytes, on ``all-gather``) and
  the partitioned forward's all-reduces (``collectives.REDUCES``: their
  payloads' bytes, on ``all-reduce``) and exchanges of product pieces
  (``collectives.EXCHANGES``: the bytes a rank receives, on
  ``collective-permute``); over ``model`` on ``axis_model``, over ``data``
  (fsdp) on ``axis_worker``.  ``gathers``, ``reduces`` and ``exchanges``
  count the calls per axes, ``gather_bytes``, ``reduce_bytes`` and
  ``exchange_bytes`` their bytes, and ``named`` the calls and bytes of
  each labelled collective (``collectives.LABELS``: the mixer's
  ``mixer_uz`` and its ``mixer_uz_grad``; where the axis cuts inside a
  head attention's ``qkv`` and its output's ``attn_out_grad``, and a
  decode's ``partial_logits`` and ``attn_out`` on an ``hd``-cut cache;
  the ``logits``);
* ``kernels``: the calls of each hand-written kernel in the step;
* ``run_s`` in place of ``lower_s`` / ``compile_s``.

The reference's ``--xla-overlap``, ``--save-hlo`` and ``--no-correct`` have
no counterpart (no XLA, no HLO, no extrapolation).  ``--reduce smoke`` runs
each config's ``reduced()`` variant at the same shapes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --step fo
    REPRO_TEST_MESH=2x2 PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import weakref
from typing import Dict, Iterator, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _pytree_leaves

from repro_torch.configs import ARCH_IDS, SHAPES, config_for_shape, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.distributed import make_distributed_ho_sgd, takes_whole_batch
from repro_torch.core.ho_sgd import HOSGDConfig
from repro_torch.device import stand_ins
from repro_torch.dist import collectives as coll
from repro_torch.dist.collectives import CommLedger
from repro_torch.dist.sharding import ShardedParams, Sharder, mesh_shape, n_workers, param_specs
from repro_torch.kernels import fake
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.train import places_shards
from repro_torch.models import transformer as T
from repro_torch.opt.optimizers import const_schedule, sgd
from repro_torch.serving.engine import serve_step
from repro_torch.tree import tree_map

#: the caching allocator's granule: every block it hands out is a multiple
ALLOC_ROUND = 512
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")
#: the CommLedger's kinds as the reference's HLO names them
_LEDGER_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce", "psum": "all-reduce",
                "pmean": "all-reduce"}


#: operations that only re-label a tensor's data (XLA's bitcasts): no bytes
_RESHAPES = (torch.ops.aten._unsafe_view.default,)


def step_kinds(shape: ShapeConfig) -> Tuple[str, ...]:
    if shape.kind == "train":
        return ("fo", "zo")
    return (shape.kind,)  # prefill | decode


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token


# --------------------------------------------------------------------------- #
# meters
# --------------------------------------------------------------------------- #
def live_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs that flash attention's masks keep, positions 0.. on
    both sides: key j is live for query i when ``(not causal or j <= i)``
    and ``(window is None or i - j < window)``."""
    if window is None:
        if not causal:
            return Sq * Sk
        n = min(Sq, Sk)
        return n * (n + 1) // 2 + max(0, Sq - Sk) * Sk
    n = 0
    for i in range(Sq):
        lo = max(0, i - window + 1)
        hi = min(Sk - 1, i) if causal else Sk - 1
        n += max(0, hi - lo + 1)
    return n


def flash_flops(q_shape, k_shape, v_shape, causal, window, softcap, out_shape=None) -> int:
    """4·hd per live (query, key) pair and head: the two products of flash
    attention, the count of its bound (PERF.md §2)."""
    B, Sq, H, hd = q_shape
    Sk = k_shape[1]
    return 4 * hd * B * H * live_pairs(Sq, Sk, causal, window)


def _storage_key(t: torch.Tensor) -> Tuple[int, int]:
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


class Meter(TorchDispatchMode):
    """Over every operation: its operand and result bytes (views excepted),
    and the device bytes live at once: each storage made on ``device`` is
    counted, rounded up to ``ALLOC_ROUND``, from the first operation that
    returns it until the last tensor that holds it is gone."""

    def __init__(self, device: str = specs.DEVICE):
        super().__init__()
        self.device = device
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}       # storage -> [tensors holding it, bytes]

    def _release(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device:
            return
        key, nbytes = _storage_key(t)
        ref = self._refs.get(key)
        if ref is None:
            nbytes = -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND
            ref = self._refs[key] = [0, nbytes]
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._release, key)

    def held(self, tree) -> int:
        """The rounded bytes of the distinct device storages in ``tree``."""
        seen = {}
        for t in _pytree_leaves(tree)[0]:
            if isinstance(t, torch.Tensor) and t.device.type == self.device:
                key, nbytes = _storage_key(t)
                seen[key] = -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND
        return sum(seen.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not (func.is_view or func in _RESHAPES):
            ins = _tensors(args) + _tensors(tuple(kwargs.values()))
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self.track(t)
        return out


def _tensors(x) -> list:
    """The tensors in an operation's arguments or results (tensors, and
    lists or tuples of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


# --------------------------------------------------------------------------- #
# the process group and the mesh
# --------------------------------------------------------------------------- #
def mesh_dims(multi_pod: bool) -> Tuple[int, ...]:
    """The mesh's sizes: ``REPRO_TEST_MESH`` (``DxM`` or ``PxDxM``) when
    set, else the production mesh's."""
    tm = os.environ.get("REPRO_TEST_MESH")
    if tm:
        return tuple(int(x) for x in tm.split("x"))
    return (2, 16, 16) if multi_pod else (16, 16)


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """A ``fake``-backend process group of ``world`` ranks seen from rank 0
    (collectives return at once, without data), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes a process group of its own; one is "
                           "already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(dims):
    if not os.environ.get("REPRO_TEST_MESH"):
        return make_production_mesh(multi_pod=len(dims) == 3, device=specs.DEVICE)
    if len(dims) == 3:
        return make_test_mesh(pod=dims[0], data=dims[1], model=dims[2], device=specs.DEVICE)
    return make_test_mesh(data=dims[0], model=dims[1], device=specs.DEVICE)


# --------------------------------------------------------------------------- #
# one target
# --------------------------------------------------------------------------- #
def _rows(batch, mesh, whole: bool):
    """This rank's rows of a global batch of stand-ins (every row with
    ``whole``, or when the worker count does not divide them)."""
    from repro_torch.data.pipeline import worker_rows

    if whole or any(x.shape[0] % n_workers(mesh) for x in _pytree_leaves(batch)[0]):
        return batch
    return worker_rows(batch, mesh)


def _collectives(ledger: CommLedger, name: str, mesh) -> Dict[str, float]:
    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    out.update(axis_model=0.0, axis_worker=0.0, axis_unknown=0.0)
    for r in ledger.programs.get(name, []):
        if r.payload:
            out[_LEDGER_KIND.get(r.kind, "all-reduce")] += r.nbytes
            out["axis_worker"] += r.nbytes
    for kind, table in (("all-gather", coll.GATHERS), ("all-reduce", coll.REDUCES),
                        ("collective-permute", coll.EXCHANGES)):
        for axes, (_, nbytes) in table.items():
            out[kind] += nbytes
            out["axis_model" if set(axes) == {"model"} else "axis_worker"] += nbytes
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    return out


def _build(cfg: ModelConfig, shape: ShapeConfig, mesh, step: str):
    """``(fn, args)``: the step and its stand-ins for this rank, made under
    the active fake mode (and meter)."""
    if step in ("fo", "zo"):
        sharder = Sharder(cfg, mesh) if places_shards(cfg, mesh) else None
        params = specs.abstract_params(cfg, shard=sharder)
        like = params if sharder is None else sharder.global_like(params)
        gathered = None if sharder is None else ShardedParams(param_specs(cfg, like, mesh), mesh)
        loss_fn = lambda p, b: T.loss_fn(cfg, p, b, gathered)  # noqa: E731
        opt = sgd(const_schedule(1e-2))
        ho = HOSGDConfig(tau=8, mu=1e-3, m=1 if cfg.fsdp else n_workers(mesh), lr=1e-2,
                         zo_lr=1e-2 / 1e6, engine="flat")
        fo, zo = make_distributed_ho_sgd(loss_fn, mesh, ho, opt, model_cfg=cfg, params_like=like)
        batch = _rows(specs.train_batch_structs(cfg, shape), mesh, takes_whole_batch(cfg))
        t = 0 if step == "fo" else 1
        return (fo if step == "fo" else zo), (t, params, opt.init(params), batch)
    seq_sharded = shape.name == "long_500k"
    sharder = Sharder(cfg, mesh) if places_shards(cfg, mesh) else None
    params = specs.abstract_params(cfg, shard=sharder)
    like = params if sharder is None else sharder.global_like(params)
    gathered = (None if sharder is None and not seq_sharded else
                ShardedParams(param_specs(cfg, like, mesh), mesh, seq_sharded=seq_sharded))
    if step == "prefill":
        batch = _rows(specs.train_batch_structs(cfg, shape, with_labels=cfg.encoder_only),
                      mesh, False)
        if cfg.encoder_only:
            return (lambda p, b: T.forward_logits(cfg, p, b, gathered)[0]), (params, batch)
        return (lambda p, b: T.prefill(cfg, p, b, gathered)), (params, batch)
    if step == "decode":
        m = n_workers(mesh)
        rows = shape.global_batch // m if shape.global_batch % m == 0 else shape.global_batch
        token, pos, caches = specs.decode_structs(cfg, shape, batch=rows, shards=gathered)
        return ((lambda p, tok, c: serve_step(cfg, p, tok, pos, c, gathered)),
                (params, token, caches))
    raise ValueError(step)


def run_one(arch: str, shape_name: Union[str, ShapeConfig], multi_pod: bool, step: str,
            verbose: bool = True, reduce: str = "full",
            cfg: Optional[ModelConfig] = None) -> Dict:
    """One target's record for rank 0 (the module docstring).
    ``shape_name`` may be a ``ShapeConfig`` of its own, ``cfg`` a config in
    place of ``arch``'s (a caller's sizes)."""
    from torch.utils.flop_counter import FlopCounterMode

    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    base = cfg if cfg is not None else get_config(arch)
    if reduce == "smoke":
        base = base.reduced()
    ok, reason = shape_applicable(base, shape)
    mesh_name = "multipod" if multi_pod else "pod"
    rec: Dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "step": step,
                 "applicable": ok, "skip_reason": reason}
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape.name} ({step}): {reason}")
        return rec

    cfg = config_for_shape(base, shape)
    if step in ("prefill", "decode"):
        cfg = cfg.with_(use_pallas=True)      # as the serving CLI runs on the card
    dims = mesh_dims(multi_pod)
    rec.update(n_layers=cfg.n_layers, period=cfg.pattern_period, n_groups=cfg.n_groups,
               params=cfg.param_count(), params_active=cfg.param_count(True),
               model_flops=model_flops(cfg, shape))
    t0 = time.perf_counter()
    with fake_group(math.prod(dims)), stand_ins():
        mesh = _mesh(dims)
        rec["mesh_shape"] = mesh_shape(mesh)
        rec["workers"] = n_workers(mesh)
        meter = Meter()
        with meter:
            fn, args = _build(cfg, shape, mesh, step)
            rec["memory"] = {"argument_size_in_bytes": float(meter.held(args))}
            meter.peak, meter.bytes = meter.live, 0
            fake.reset_calls()
            coll.reset_gathers()
            ledger = CommLedger()
            flops = FlopCounterMode(display=False, custom_mapping={fake.FLASH_OP: flash_flops})
            grad = step in ("fo", "zo")
            with flops, torch.set_grad_enabled(grad):
                out = ledger.wrap(step, fn)(*args)
            rec["memory"]["peak_memory_in_bytes"] = float(meter.peak)
            rec["memory"]["output_size_in_bytes"] = float(meter.held(out))
            del out, args, fn
        a = rec["memory"]
        a["temp_size_in_bytes"] = a["peak_memory_in_bytes"] - a["argument_size_in_bytes"]
        rec["cost"] = {"flops": float(flops.get_total_flops()), "bytes": float(meter.bytes)}
        rec["collectives"] = _collectives(ledger, step, mesh)
        for name, table in (("gather", coll.GATHERS), ("reduce", coll.REDUCES),
                            ("exchange", coll.EXCHANGES)):
            rec[f"{name}s"] = {"+".join(k): v[0] for k, v in table.items()}
            rec[f"{name}_bytes"] = {"+".join(k): v[1] for k, v in table.items()}
        rec["named"] = {k: list(v) for k, v in sorted(coll.LABELS.items())}
        rec["kernels"] = {k: v for k, v in fake.CALLS.items() if v}
    rec["run_s"] = round(time.perf_counter() - t0, 2)
    if verbose:
        c, mem = rec["cost"], rec["memory"]
        print(f"[ok] {arch} x {shape.name} x {mesh_name} ({step}): "
              f"flops={c['flops']:.3e} bytes={c['bytes']:.3e} "
              f"coll={rec['collectives']['total']:.3e}B "
              f"argbytes={mem['argument_size_in_bytes']:.3e} "
              f"temp={mem['temp_size_in_bytes']:.3e} "
              f"peak={mem['peak_memory_in_bytes']:.3e} kernels={rec['kernels']} "
              f"(run {rec['run_s']}s)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--step", default="auto")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reduce", default="full", choices=["full", "smoke"],
                    help="smoke: each config's reduced() variant at the same shapes")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multipod"]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                kinds = (step_kinds(SHAPES[shape_name]) if args.step == "auto"
                         else (args.step,))
                for step in kinds:
                    tag = f"{arch}__{shape_name}__{'multipod' if mp else 'pod'}__{step}"
                    out_path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(out_path) and not args.force:
                        with open(out_path) as f:
                            prev = json.load(f)
                        if "error" not in prev:
                            print(f"[resume] {tag}: already done")
                            n_ok += prev.get("applicable", False)
                            n_skip += not prev.get("applicable", False)
                            continue
                    try:
                        rec = run_one(arch, shape_name, mp, step, reduce=args.reduce)
                        n_ok += rec.get("applicable", False)
                        n_skip += not rec.get("applicable", False)
                    except Exception as e:  # a failure here is a bug: report it
                        n_fail += 1
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": "multipod" if mp else "pod",
                               "step": step, "applicable": True,
                               "error": f"{type(e).__name__}: {e}"}
                        print(f"[FAIL] {tag}: {rec['error']}")
                    with open(out_path, "w") as f:
                        json.dump(rec, f, indent=1)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
