"""End-to-end distributed training driver (HO-SGD), in PyTorch.

Counterpart of ``repro.launch.train``, with its flags, output lines, CSV
columns and ledger bytes.  Train a decoder with HO-SGD on the card:

    python -m repro_torch.launch.train --arch gemma2-2b --reduce full \\
        --steps 6 --tau 3 --batch 8 --seq 128 --engine flat --log l.csv
    python -m repro_torch.launch.train --device cpu --arch gemma2-2b --reduce smoke \\
        --steps 9 --tau 3 --batch 4 --seq 32 --engine flat --ckpt ck

Under a process group of several ranks (each rank runs ``main``; the
caller initialises the group, as ``launch.mesh.spawn_ranks`` does), the
mesh is ``(data, model)`` with ``--model-axis`` ranks on ``model`` and the
rest on ``data`` (the workers).  ``--model-axis`` > 1 runs the reference's
tensor-parallel placements and an ``fsdp`` architecture (arctic-480b,
qwen3-moe-235b-a22b) also shards over ``data``: each rank keeps only its
shard of every leaf, drawn from the same generator in the same order as the
replicated run's (``models.transformer.init_model(..., shard=)``), and the
loss runs the forward partitioned over ``model`` (Megatron's convention:
each rank its heads, hidden columns and vocabulary columns, one all-reduce
a sublayer), the ``data`` cut gathered on use (``dist.sharding``).  Rank 0
prints, writes the CSV, the trace and ``--ckpt`` (gathered whole, in the
one on-disk format, so it restores in either package and on any mesh;
``checkpoint.restore(..., shards=)`` slices it onto a sharded mesh).

Every ``--tau``-th step (or as ``--tau-schedule`` decides) is a first-order
step, an all-reduce of the gradient (4·d bytes with ``grad_accum`` > 1, the
parameters' width otherwise); the rest are zeroth-order steps, one scalar per
worker.  The CSV has a row per step (``step, order, loss, dt, comm_bytes``),
and the run ends with the CommLedger's measured-vs-analytic lines.

What differs from the reference:

* ``--device`` (default ``cuda``; without a GPU that raises, never a silent
  CPU run) picks where the parameters and steps live.
* The mesh is a ``DeviceMesh`` over a ``torch.distributed`` process group.
  When the caller has not initialised one, ``main`` opens a world-size-1
  gloo group over a ``file://`` store in a temporary directory and destroys
  it on exit; under the caller's group the device count is its world size.
* The partitioned forward's all-reduces are written out (float32 partials
  summed in rank order), where the reference's compiler inserts its own;
  the mamba mixer gathers its ``in_proj`` over ``model`` (``models.ssm``).
* ``--xla-overlap`` has no counterpart (it sets ``XLA_FLAGS``, which
  PyTorch does not have) and exits with a message.
* ``--trace`` makes its wall tracer the process's active one
  (``repro_torch.obs.active``), so the program's own spans (``fo.step``,
  ``fo.microbatch``, ``zo.loss``, ``engine.sumsq``, ...) nest under each
  step's span, each with its card time (``device_ms``) on CUDA.

Frontend architectures (vision, audio) exit with the reference's message:
their batches need image embeddings or features, which the token stream
does not make.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time

import torch

from repro_torch import obs
from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import make_distributed_ho_sgd, takes_whole_batch
from repro_torch.core.ho_sgd import HOSGDConfig, adaptive_tau_decision, parse_tau_schedule
from repro_torch.data import shard_batches, token_batches
from repro_torch.device import resolve_device
from repro_torch.dist import CommLedger, get_compressor
from repro_torch.dist.sharding import (
    Sharder, ShardedParams, ShardGeometry, gather_tree, mesh_shape, n_workers, param_specs)
from repro_torch.launch.mesh import make_test_mesh, process_group
from repro_torch.metrics import CSVLogger, comm_report
from repro_torch.models import transformer as T
from repro_torch.models.transformer import init_model
from repro_torch.opt.optimizers import const_schedule, sgd
from repro_torch.tree import tree_leaves, tree_map


def size_override(cfg: ModelConfig, preset: str) -> ModelConfig:
    """Depth/width presets so examples fit the local device."""
    if preset == "full":
        return cfg
    if preset == "100m":
        return cfg.with_(
            n_layers=max(cfg.pattern_period * 4, 8), d_model=768,
            n_heads=12, n_kv_heads=max(1, min(cfg.n_kv_heads, 4)),
            head_dim=64, d_ff=2048, dense_d_ff=min(cfg.dense_d_ff, 2048),
            vocab_size=min(cfg.vocab_size, 32768),
            n_experts=min(cfg.n_experts, 8), dt_rank=48,
            dtype="float32",
        )
    if preset == "smoke":
        return cfg.reduced()
    raise ValueError(preset)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--reduce", default="smoke", choices=["full", "100m", "smoke"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--tau-schedule", default=None,
                    help="adaptive period: 'const:K' or "
                         "'linear:start,end,horizon' (needs --tau >= 2; "
                         "default: fixed --tau)")
    ap.add_argument("--mu", type=float, default=1e-3)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--zo-lr", type=float, default=None)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-axis", type=int, default=0, help="0 = all devices")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log", default=None)
    ap.add_argument("--compress", default="none",
                    choices=["none", "qsgd", "signsgd", "topk"],
                    help="codec on the FO gradient all-reduce")
    ap.add_argument("--compress-mode", default="per_worker",
                    choices=["per_worker", "legacy"],
                    help="per_worker: each worker encodes its shard "
                         "gradient, the reducer decodes (wire = nbytes x m);"
                         " legacy: post-reduction decode(encode(mean))")
    ap.add_argument("--engine", default="fused",
                    choices=["tree", "fused", "pallas", "flat"],
                    help="DirectionEngine backend for the ZO direction "
                         "algebra (repro_torch.core.engine); 'pallas' runs the "
                         "per-leaf CUDA kernels, 'flat' packs the tree into "
                         "one buffer for the flat ones")
    ap.add_argument("--fo-buckets", type=int, default=1,
                    help="chunk the FO gradient all-reduce into this many "
                         "buckets (the same values and ledger bytes; eager "
                         "PyTorch runs one reduction: core.distributed)")
    ap.add_argument("--xla-overlap", action="store_true",
                    help="the reference's XLA collective-overlap flags; no "
                         "counterpart in the port (exits with a message)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a wall-clock Perfetto trace: one span per "
                         "FO/ZO step (ledger bytes attached), the program's "
                         "own spans inside it (repro_torch.obs.span), plus a "
                         "cumulative received-bytes counter")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.xla_overlap:
        raise SystemExit("--xla-overlap sets XLA's collective-overlap flags and has no "
                         "counterpart in the port: PyTorch has no XLA_FLAGS")
    cfg = size_override(get_config(args.arch), args.reduce)
    if cfg.frontend != "none":
        raise SystemExit("use examples/ drivers for frontend archs")
    dev = resolve_device(args.device)
    with process_group() as n_dev:
        return _train(args, cfg, dev, n_dev)


def init_params(cfg: ModelConfig, mesh, seed: int, dev: torch.device):
    """``(params, params_like)``: this rank's shards of the seeded
    parameters, and a tree of the global shapes as meta tensors (no data:
    the trainer keeps it for the whole run, where a tree of the initial
    parameters would hold their bytes on the card).  A mesh that no
    placement cuts (``model`` of one rank, and no ``fsdp`` over several
    ``data`` ranks) gets the whole parameters."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if not places_shards(cfg, mesh):
        params = init_model(gen, cfg, device=dev)
        return params, tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                                params)
    sharder = Sharder(cfg, mesh)
    params = init_model(gen, cfg, device=dev, shard=sharder)
    return params, sharder.global_like(params)


def places_shards(cfg: ModelConfig, mesh) -> bool:
    """Whether a placement cuts a leaf: ``model`` over several ranks, or
    ``fsdp`` over several ``data`` ranks."""
    shape = mesh_shape(mesh)
    return shape.get("model", 1) > 1 or bool(cfg.fsdp and shape.get("data", 1) > 1)


def _train(args, cfg: ModelConfig, dev: torch.device, n_dev: int) -> float:
    import torch.distributed as dist

    data_ax = args.data_axis or max(1, n_dev // args.model_axis)
    mesh = make_test_mesh(data=data_ax, model=args.model_axis, device=dev.type)
    m = n_workers(mesh)
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **kw: None)
    say(f"arch={cfg.name} params={cfg.param_count():,} mesh={mesh_shape(mesh)} "
        f"workers={m}")

    params, like = init_params(cfg, mesh, args.seed, dev)
    specs = param_specs(cfg, like, mesh)
    geom = ShardGeometry.from_global(specs, like, mesh)
    shards = ShardedParams(specs, mesh) if geom.sharded else None
    loss_fn = lambda p, b: T.loss_fn(cfg, p, b, shards)  # noqa: E731
    leaf_dims = [math.prod(s) for s in geom.shapes]
    d = sum(leaf_dims)
    if geom.sharded:
        held = sum(x.numel() * x.element_size() for x in tree_leaves(params))
        say(f"sharded over {geom.shard_axes} (the forward partitioned over 'model'): rank 0 "
            f"holds {held:,} of {geom.global_nbytes(params):,} parameter bytes")
    zo_lr = args.zo_lr if args.zo_lr is not None else args.lr * 50.0 / d
    ho = HOSGDConfig(tau=args.tau, mu=args.mu, m=m, lr=args.lr, zo_lr=zo_lr,
                     seed=args.seed, engine=args.engine)
    opt = sgd(const_schedule(args.lr))
    codec = get_compressor(args.compress)
    fo, zo = make_distributed_ho_sgd(loss_fn, mesh, ho, opt, model_cfg=cfg,
                                     params_like=like, compressor=codec,
                                     compress_mode=args.compress_mode,
                                     fo_buckets=args.fo_buckets)

    # adaptive tau: the same decision logic the Method uses
    # (core.ho_sgd.adaptive_tau_decision); the fixed-tau default keys each
    # step on t itself
    tau_sched = parse_tau_schedule(args.tau_schedule) if args.tau_schedule else None
    if tau_sched is not None and args.tau < 2:
        raise SystemExit("--tau-schedule needs --tau >= 2 (the ZO seed map)")

    opt_state = opt.init(params)
    ledger = CommLedger()
    fo_j = ledger.wrap("fo", fo)
    zo_j = ledger.wrap("zo", zo)

    host = token_batches(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    since_fo = 0
    tracer = None
    if args.trace and lead:
        # active for the run: the program's own spans (core, engine) nest
        # under each step's, with the card's time of each on CUDA
        tracer = obs.Tracer(clock="wall", device=dev.type == "cuda")
    with (obs.active(tracer) if tracer is not None else contextlib.nullcontext()), \
            CSVLogger(args.log if lead else None,
                      ["step", "order", "loss", "dt", "comm_bytes"]) as logger:
        t_prev = time.perf_counter()
        batches = shard_batches(host, mesh, whole=takes_whole_batch(cfg))
        for t, batch in zip(range(args.steps), batches):
            if tau_sched is None:
                is_fo, t_step = t % args.tau == 0, t
            else:
                is_fo, t_step, since_fo = adaptive_tau_decision(
                    t, since_fo, tau_sched(t), args.tau)
            name = "fo" if is_fo else "zo"
            step = fo_j if is_fo else zo_j
            t0 = time.perf_counter()
            if tracer is not None:
                with tracer.span("compute", "train", name=f"{name}/{t}") as sp:
                    params, opt_state, loss = step(t_step, params, opt_state, batch)
                    loss = float(loss)       # waits for the card
                    sp.nbytes = ledger.bytes_per_step(name)
                tracer.counter(tracer.now(), "train", "ledger_bytes", ledger.total_bytes())
            else:
                params, opt_state, loss = step(t_step, params, opt_state, batch)
                loss = float(loss)           # waits for the card
            dt_step = time.perf_counter() - t0
            if t % 10 == 0 or t == args.steps - 1:
                now = time.perf_counter()
                say(f"step {t:5d} ({'FO' if is_fo else 'ZO'}) "
                    f"loss={loss:.4f} dt={now - t_prev:.2f}s")
                t_prev = now
            logger.log(step=t, order=int(is_fo), loss=loss, dt=dt_step,
                       comm_bytes=ledger.bytes_per_step(name))
        if args.ckpt:
            if tracer is not None:
                with tracer.span("checkpoint", "train", name="ckpt_save"):
                    path = _save(args.ckpt, args.steps, params, specs, mesh, geom, lead)
            else:
                path = _save(args.ckpt, args.steps, params, specs, mesh, geom, lead)
            say("checkpoint:", path)
    if tracer is not None:
        tracer.resolve()
        obs.write_trace(args.trace, tracer, title=f"train:{cfg.name}")
        say(f"wrote trace {args.trace} ({len(tracer.spans)} spans)")
    # the dense FO exchange moves gradients in the parameters' dtype (a
    # float32 accumulator with grad_accum microbatches); ZO coefficients are
    # always float32
    grad_bytes = 4 if cfg.grad_accum > 1 else getattr(torch, cfg.dtype).itemsize
    for line in comm_report(ledger, d=d, m=m, tau=args.tau, codec=codec,
                            leaf_dims=leaf_dims, grad_bytes=grad_bytes):
        say(line)
    say("done; final loss", float(loss))
    return float(loss)


def _save(ckpt_dir: str, step: int, params, specs, mesh, geom: ShardGeometry,
          lead: bool):
    """``--ckpt``: the parameters whole, on rank 0.  Sharded leaves are
    gathered through host memory (every rank takes part), so no rank holds
    a second whole tree on the card."""
    if geom.sharded:
        with torch.no_grad():
            params = gather_tree(tree_map(lambda x: x.cpu(), params), specs, mesh)
    return ckpt_save(ckpt_dir, step, params) if lead else None


if __name__ == "__main__":
    main()
