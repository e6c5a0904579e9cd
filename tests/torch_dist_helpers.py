"""What the spawned ranks of tests/test_torch_distributed.py and
tests/test_torch_sharded.py run.

A module of its own, imported by the children as a top-level module (the
test files import jax; the ranks need torch and the port only).  Every rank
builds the same meshes over the group it joined, runs each case's steps on
its own rows (``data.pipeline.shard_batches``) and returns what the test
compares: losses, final parameters, the ledger's bytes and the rows it got.
The sharded ranks (``run_sharded_8``, ``_4``, ``_2``) cut the whole
parameters they are handed into their shards, step on them, and return the
parameters gathered whole.
"""
import torch

from repro_torch.core.distributed import (
    make_distributed_ho_sgd, make_fo_step, make_zo_step, takes_whole_batch)
from repro_torch.core.ho_sgd import HOSGDConfig
from repro_torch.data.pipeline import shard_batches, take
from repro_torch.dist import CommLedger, collectives as coll
from repro_torch.dist.compress import qsgd
from repro_torch.dist.sharding import worker_index
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.opt.optimizers import const_schedule, sgd

TAU = 4


class FakeMesh:
    """A mesh's geometry alone, seen from one rank: axis names and sizes and
    this rank's coordinates (what ``dist.sharding.ShardGeometry`` reads of a
    ``DeviceMesh``); no group is needed to lay a shard out."""

    def __init__(self, coord, **sizes):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())
        self._coord = [coord[a] for a in sizes]

    def get_coordinate(self):
        return self._coord

#: (name, mesh kwargs, engine, compressor name, compress mode)
CASES = [("tree", dict(data=4, model=1), "tree", None, "per_worker"),
         ("flat", dict(data=4, model=1), "flat", None, "per_worker"),
         ("pallas", dict(data=4, model=1), "pallas", None, "per_worker"),
         ("flat-pod", dict(pod=2, data=2, model=1), "flat", None, "per_worker"),
         ("qsgd", dict(data=4, model=1), "tree", "qsgd", "per_worker"),
         ("qsgd-legacy", dict(data=4, model=1), "tree", "qsgd", "legacy")]


def quad_loss(params, batch):
    return 0.5 * torch.mean(torch.sum((params["x"] - batch["t"]) ** 2, -1))


def ho_config(engine, m=4):
    return HOSGDConfig(tau=TAU, mu=1e-3, m=m, lr=0.1, zo_lr=0.05, engine=engine)


def run_case(mesh, engine, codec, mode, batches, steps):
    comp = None if codec is None else qsgd(8)
    fo, zo = make_distributed_ho_sgd(quad_loss, mesh, ho_config(engine), compressor=comp,
                                     compress_mode=mode)
    ledger = CommLedger()
    fo, zo = ledger.wrap("fo", fo), ledger.wrap("zo", zo)
    params, state = {"x": torch.linspace(-1.0, 1.0, batches[0]["t"].shape[1])}, ()
    losses, rows = [], []
    for t, b in enumerate(take(shard_batches(iter(batches), mesh), steps)):
        rows.append(b["t"].numpy().copy())
        params, state, loss = (fo if t % TAU == 0 else zo)(t, params, state, b)
        losses.append(float(loss))
    return {"losses": losses, "x": params["x"].numpy(), "rows": rows,
            "fo_bytes": ledger.bytes_per_step("fo"), "zo_bytes": ledger.bytes_per_step("zo"),
            "zo_kinds": ledger.by_kind("zo")}


def run_cases(rank, world, batches, steps):
    torch.set_num_threads(1)
    out = {}
    for name, mesh_kw, engine, codec, mode in CASES:
        mesh = make_test_mesh(device="cpu", **mesh_kw)
        out[name] = run_case(mesh, engine, codec, mode, batches, steps)
        out[name]["worker"] = worker_index(mesh)
    mesh = make_test_mesh(pod=2, data=2, model=1, device="cpu")
    w = torch.tensor(float(worker_index(mesh)))
    out["gather"] = coll.all_gather(w, ("pod", "data"), mesh=mesh).numpy()
    out["psum"] = float(coll.psum({"w": w}, ("pod", "data"), mesh=mesh)["w"])
    out["pmean_data"] = float(coll.pmean(w, "data", mesh=mesh))
    out["sharded"] = run_sharded_quad(make_test_mesh(data=2, model=2, device="cpu"), batches,
                                      steps)
    return out


def run_sharded_quad(mesh, batches, steps):
    """The quadratic's x placed by a spec on (data=2, model=2): cut over
    ``model`` (2 workers, FO and ZO steps), and under fsdp over ``data``
    (one worker, every rank the whole batch; ZO steps).  Returns the shapes
    this rank holds, x gathered whole and the losses."""
    from repro_torch.dist.sharding import P, gather, gather_tree, shard_tree

    out = {}
    for case, spec, fsdp in (("model", P("model"), False), ("fsdp", P("data"), True)):
        specs = {"x": spec}
        loss = lambda p, b, s=spec: quad_loss({"x": gather(p["x"], s, mesh)}, b)  # noqa: E731
        opt = sgd(const_schedule(0.1))
        ho = ho_config("tree", m=1 if fsdp else 2)
        fo = make_fo_step(loss, mesh, opt, m=2, param_specs_tree=specs, fsdp=fsdp)
        zo = make_zo_step(loss, mesh, ho, opt, fsdp=fsdp, param_specs_tree=specs)
        p = shard_tree({"x": torch.linspace(-1.0, 1.0, batches[0]["t"].shape[1])}, specs, mesh)
        losses = []
        for t, b in enumerate(take(shard_batches(iter(batches), mesh, whole=fsdp), steps)):
            p, _, l = (fo if t % TAU == 0 else zo)(t, p, (), b)
            losses.append(float(l))
        out[case] = {"held": [tuple(p["x"].shape)], "losses": losses,
                     "x": gather_tree(p, specs, mesh)["x"].numpy()}
    return out



# --------------------------------------------------------------------------- #
# sharded placements: the spawned ranks of tests/test_torch_sharded.py
# --------------------------------------------------------------------------- #
ZO_T = 5
SMOKE = ["--device", "cpu", "--arch", "gemma2-2b", "--reduce", "smoke", "--steps", "9",
         "--tau", "3", "--batch", "4", "--seq", "32", "--engine", "flat"]


def llm_config(d, m, engine="tree"):
    """The distributed check's HO-SGD config (tests/helpers/dist_check.py)."""
    return HOSGDConfig(tau=4, mu=1e-3, m=m, lr=0.05, zo_lr=0.05 / d, engine=engine)


def sharded_model(cfg, mesh, full):
    """``(shards, specs, loss, losses)``: this rank's shards of the whole
    parameters ``full``, their specs, the loss that gathers them on use,
    and the list that loss appends each value to."""
    from repro_torch.dist.sharding import ShardedParams, param_specs, shard_tree
    from repro_torch.models import transformer as T

    specs = param_specs(cfg, full, mesh)
    gathered = ShardedParams(specs, mesh)
    losses = []

    def loss(p, b):
        out = T.loss_fn(cfg, p, b, gathered)
        losses.append(float(out.detach()))
        return out

    return shard_tree(full, specs, mesh), specs, loss, losses


def _counts():
    """The collectives counted since ``collectives.reset_gathers``: gathers,
    all-reduces and exchanges (axes -> [calls, bytes]), and the labelled
    ones (label -> [calls, bytes])."""
    return {name: {k: list(v) for k, v in table.items()}
            for name, table in (("gathers", coll.GATHERS), ("reduces", coll.REDUCES),
                                ("exchanges", coll.EXCHANGES), ("labels", coll.LABELS))}


def sharded_step(cfg, mesh, full, batch, ho, kind, t, **kw):
    """One FO or ZO step of ``make_distributed_ho_sgd`` on this rank's
    shards: the gathered parameters (numpy, on rank 0), their checksum, the
    shapes held, the loss, this rank's loss evaluations in order (the first
    its f0 on a ZO step), the ledger's bytes, this rank's rows and worker, and the
    gathers, all-reduces and exchanges the step made (``collectives.GATHERS``,
    ``REDUCES``, ``EXCHANGES``: axes -> [calls, bytes])."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import gather_tree
    from repro_torch.tree import tree_leaves

    shards, specs, loss, losses = sharded_model(cfg, mesh, full)
    fo, zo = make_distributed_ho_sgd(loss, mesh, ho, model_cfg=cfg, params_like=full, **kw)
    ledger = CommLedger()
    step = ledger.wrap(kind, fo if kind == "fo" else zo)
    b = next(iter(shard_batches(iter([batch]), mesh, whole=takes_whole_batch(cfg))))
    coll.reset_gathers()
    p, _, out = step(t, shards, (), b)
    counts = _counts()
    whole = [x.numpy() for x in tree_leaves(gather_tree(p, specs, mesh))]
    return {"params": whole if dist.get_rank() == 0 else None,
            "checksum": float(sum(x.astype("float64").sum() for x in whole)),
            "held": [tuple(x.shape) for x in tree_leaves(p)], "loss": float(out),
            "f0": losses[0], "losses": list(losses), "bytes": ledger.bytes_per_step(kind),
            "kinds": ledger.by_kind(kind), "rows": b["tokens"].numpy().copy(),
            "worker": worker_index(mesh), **counts}


def engine_pins(cfg, mesh, full, engine, m):
    """This rank's engine over its shards: its d, the m workers' Σv² at step
    ZO_T (the norm's collective), and (flat) its block and packed size."""
    from repro_torch.core.engine import make_engine

    shards, specs, _, _ = sharded_model(cfg, mesh, full)
    eng = make_engine(engine, shards, 0, specs=specs, mesh=mesh)
    return {"dim": eng.dim, "sumsq": eng.sumsq_many(ZO_T, list(range(m))).tolist(),
            "block": eng.block, "packed_over_shard": getattr(eng, "packed_over_shard", None)}


def _full(np_tree):
    from repro_torch.convert import params_from_numpy
    from repro_torch.tree import tree_leaves

    full = params_from_numpy(np_tree, device="cpu")
    return full, sum(x.numel() for x in tree_leaves(full))


def run_sharded_8(rank, world, full_np, batch):
    """(data=4, model=2), qwen3-14b reduced, m=4: ZO steps on tree and flat,
    an FO step dense and with per-worker QSGD, the engines' pins."""
    from repro_torch.configs import get_config

    torch.set_num_threads(1)
    cfg = get_config("qwen3-14b").reduced()
    full, d = _full(full_np)
    mesh = make_test_mesh(data=4, model=2, device="cpu")
    out = {"worker": worker_index(mesh)}
    for engine in ("tree", "flat"):
        out[f"zo-{engine}"] = sharded_step(cfg, mesh, full, batch, llm_config(d, 4, engine),
                                           "zo", ZO_T)
        out[f"pins-{engine}"] = engine_pins(cfg, mesh, full, engine, 4)
    out["fo"] = sharded_step(cfg, mesh, full, batch, llm_config(d, 4), "fo", 0)
    out["fo-qsgd"] = sharded_step(cfg, mesh, full, batch, llm_config(d, 4), "fo", 0,
                                  compressor=qsgd(8))
    return out


def run_sharded_4(rank, world, moe_np, batch, tmp):
    """(data=2, model=2): qwen3-moe reduced under fsdp (m=1, every rank the
    whole batch), then the trainer's CLI at --model-axis 2 and 4 with a
    sharded --ckpt (rank 0 writes the CSV and the checkpoint)."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.launch import train as TT
    from repro_torch.tree import tree_leaves

    torch.set_num_threads(1)
    cfg = get_config("qwen3-moe-235b-a22b").reduced().with_(fsdp=True)
    full, d = _full(moe_np)
    mesh = make_test_mesh(data=2, model=2, device="cpu")
    out = {"zo": sharded_step(cfg, mesh, full, batch, llm_config(d, 1), "zo", ZO_T),
           "fo": sharded_step(cfg, mesh, full, batch, llm_config(d, 1), "fo", 0),
           "pins": engine_pins(cfg, mesh, full, "flat", 1)}
    saved, real = {}, TT.ckpt_save

    def capture(ckpt_dir, step, tree):
        saved[ckpt_dir] = [x.numpy() for x in tree_leaves(tree)]
        return real(ckpt_dir, step, tree)

    TT.ckpt_save = capture               # what rank 0 saves: the gathered tree
    try:
        for axis in (2, 4):
            base = os.path.join(tmp, f"model{axis}")
            TT.main(SMOKE + ["--model-axis", str(axis), "--log", base + ".csv",
                             "--ckpt", base + "-ck"])
    finally:
        TT.ckpt_save = real
    out["saved"] = saved
    return out


def quad_rows(params, batch):
    """A quadratic loss on a (3, 8, 6) leaf: 0.5 * mean over rows of
    |w - t|^2."""
    return 0.5 * torch.mean(torch.sum((params["w"].reshape(-1) - batch["t"]) ** 2, -1))


def without_mlp_reduce():
    """A failing control: the partitioned MLP's all-reduce removed (each
    rank keeps its own partial), for as long as the context is open."""
    import contextlib

    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    @contextlib.contextmanager
    def patched():
        real = T.apply_mlp

        def apply_mlp(cfg, p, x, tp=None):
            if tp is None:
                return real(cfg, p, x)
            return layers.mlp_partial(cfg, p, tp.enter(x)).to(x.dtype)

        T.apply_mlp = apply_mlp
        try:
            yield
        finally:
            T.apply_mlp = real

    return patched()


def run_sharded_2(rank, world, full_np, batch, quad_batch):
    """(data=1, model=2): the FO step of qwen3-14b reduced (m=4 held in the
    process), the same step without the MLP's all-reduce (the control), and
    the pallas engine's run table on a (3, 8, 6) leaf cut on dim 1
    (three runs) against the tree engine."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import P, gather, gather_tree, shard_tree

    torch.set_num_threads(1)
    cfg = get_config("qwen3-14b").reduced()
    full, d = _full(full_np)
    mesh = make_test_mesh(data=1, model=2, device="cpu")
    out = {"fo": sharded_step(cfg, mesh, full, batch, llm_config(d, 4), "fo", 0)}
    with without_mlp_reduce():
        out["fo-no-mlp-reduce"] = sharded_step(cfg, mesh, full, batch, llm_config(d, 4), "fo", 0)
    specs = {"w": P(None, "model")}
    loss = lambda p, b: quad_rows({"w": gather(p["w"], specs["w"], mesh)}, b)  # noqa: E731
    w = torch.linspace(-1.0, 1.0, 144).reshape(3, 8, 6)
    for engine in ("pallas", "tree"):
        ho = HOSGDConfig(tau=4, mu=1e-3, m=2, lr=0.1, zo_lr=0.05, engine=engine)
        zo = make_zo_step(loss, mesh, ho, sgd(const_schedule(0.05)), param_specs_tree=specs)
        p, _, l = zo(1, shard_tree({"w": w}, specs, mesh), (), quad_batch)
        out[f"quad-{engine}"] = {"w": gather_tree(p, specs, mesh)["w"].numpy(),
                                 "loss": float(l)}
    return out


def _rows_seen(loss):
    """``loss`` that also records the token rows of every batch it sees."""
    seen = []

    def wrapped(p, b):
        seen.append(b["tokens"].numpy().copy())
        return loss(p, b)

    return wrapped, seen


def run_moe_4(rank, world, moe_np, dense_np, batches, steps):
    """(data=2, model=2), fsdp off, m=2: qwen3-moe reduced for ``steps``
    steps at tau 4 (every rank the global batch: the FO step's gradient is
    the global batch's, the ZO step cuts the worker's rows), the rows each
    step's loss saw; the FO step with per-worker and legacy QSGD (their
    rows); a dense FO step (qwen3-14b reduced) against the rank-per-worker
    step written out: the worker's rows, their gradient averaged over the
    worker axes, the SGD update."""
    from repro_torch.configs import get_config
    from repro_torch.core.ho_sgd import value_and_grad
    from repro_torch.dist.sharding import gather_tree, worker_axes
    from repro_torch.opt.optimizers import apply_deltas
    from repro_torch.tree import tree_leaves, tree_map

    torch.set_num_threads(1)
    mesh = make_test_mesh(data=2, model=2, device="cpu")
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    full, d = _full(moe_np)
    shards, specs, loss, _ = sharded_model(cfg, mesh, full)
    loss, seen = _rows_seen(loss)
    ho = llm_config(d, 2)
    fo, zo = make_distributed_ho_sgd(loss, mesh, ho, model_cfg=cfg, params_like=full)
    ledger = CommLedger()
    fo, zo = ledger.wrap("fo", fo), ledger.wrap("zo", zo)
    out = {"worker": worker_index(mesh), "whole": takes_whole_batch(cfg), "losses": [],
           "rows": [], "bytes": []}
    p, state = shards, ()
    host = shard_batches(iter(batches), mesh, whole=takes_whole_batch(cfg))
    for t, b in enumerate(take(host, steps)):
        kind = "fo" if t % TAU == 0 else "zo"
        del seen[:]
        p, state, l = (fo if kind == "fo" else zo)(t, p, state, b)
        out["losses"].append(float(l))
        out["rows"].append([r for r in seen])
        out["bytes"].append(ledger.bytes_per_step(kind))
    out["final"] = [x.numpy() for x in tree_leaves(gather_tree(p, specs, mesh))]
    for mode in ("per_worker", "legacy"):
        del seen[:]
        f, _ = make_distributed_ho_sgd(loss, mesh, ho, model_cfg=cfg, params_like=full,
                                       compressor=qsgd(8), compress_mode=mode)
        f(0, shards, (), next(iter(shard_batches(iter(batches[:1]), mesh, whole=True))))
        out[f"rows-{mode}"] = [r for r in seen]
    # the dense FO step, and the same step written out as the rank-per-worker
    # formulation computes it
    dcfg = get_config("qwen3-14b").reduced()
    dfull, dd = _full(dense_np)
    dshards, dspecs, dloss, _ = sharded_model(dcfg, mesh, dfull)
    dho = llm_config(dd, 2)
    dfo, _ = make_distributed_ho_sgd(dloss, mesh, dho, model_cfg=dcfg, params_like=dfull)
    b = next(iter(shard_batches(iter(batches[:1]), mesh, whole=takes_whole_batch(dcfg))))
    got, _, gl = dfo(0, dshards, (), b)
    l, g = value_and_grad(dloss, dshards, b)
    g = coll.pmean(g, worker_axes(mesh), mesh=mesh)
    want = apply_deltas(dshards, tree_map(lambda x: -dho.lr * x.to(torch.float32), g))
    out["dense"] = {"whole": takes_whole_batch(dcfg),
                    "rows": b["tokens"].numpy().copy(),
                    "equal": all(torch.equal(a, w) for a, w in
                                 zip(tree_leaves(got), tree_leaves(want))),
                    "loss_equal": float(gl) == float(coll.pmean(l, worker_axes(mesh),
                                                                mesh=mesh))}
    return out


def card_gather(rank, world):
    """``gather_cat`` between ranks that share ``cuda:0`` (the same-card
    exchange): a bf16 part on dims 0 and 1, then a part that grows the
    buffers."""
    torch.cuda.set_device(0)
    mesh = make_test_mesh(data=1, model=world, device="cuda")
    x = (torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * rank).to(
        torch.bfloat16).cuda()
    out = {d: coll.gather_cat(x, "model", mesh=mesh, dim=d).float().cpu().numpy()
           for d in (0, 1)}
    big = torch.full((1 << 20,), float(rank + 1), device="cuda")
    out["big"] = coll.gather_cat(big, "model", mesh=mesh, dim=0).cpu().numpy()
    out["card"] = coll._CARDS[mesh][("model",)] is not None
    return out


def card_all_reduce(rank, world):
    """``collectives.all_reduce_sum`` between ranks that share ``cuda:0``:
    a float32 and a bf16 part of each rank's own values (the bf16 sum
    rounded once), the result's bits on this rank and what the counter
    booked."""
    torch.cuda.set_device(0)
    mesh = make_test_mesh(data=1, model=world, device="cuda")
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(3, 1000, generator=gen).cuda()
    coll.reset_gathers()
    out = {dt: coll.all_reduce_sum(x.to(dt), "model", mesh=mesh).float().cpu().numpy()
           for dt in (torch.float32, torch.bfloat16)}
    return {"sums": out, "reduces": dict(coll.REDUCES), "gathers": dict(coll.GATHERS),
            "card": coll._CARDS[mesh][("model",)] is not None}


def run_dry_twin(rank, world, batch):
    """(data=2, model=2): gemma2-2b reduced, this rank's shards drawn as the
    trainer draws them, one FO and one ZO step on the CPU: the gathers and
    all-reduces each step made (``collectives.GATHERS``, ``REDUCES``), the
    ledger's payload bytes by kind,
    and the FO step's peak live bytes and arguments by ``launch.dryrun``'s
    ``Meter`` on these real CPU tensors (the dry run's twin)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import worker_rows
    from repro_torch.dist.sharding import ShardedParams, param_specs
    from repro_torch.launch.dryrun import Meter
    from repro_torch.launch.train import init_params
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    cfg = get_config("gemma2-2b").reduced()
    mesh = make_test_mesh(data=2, model=2, device="cpu")
    out = {}
    for kind in ("fo", "zo"):
        meter = Meter(device="cpu")
        with meter:
            params, like = init_params(cfg, mesh, 0, torch.device("cpu"))
            gathered = ShardedParams(param_specs(cfg, like, mesh), mesh)
            fo, zo = make_distributed_ho_sgd(
                lambda p, b: T.loss_fn(cfg, p, b, gathered), mesh,
                HOSGDConfig(tau=8, mu=1e-3, m=2, lr=1e-2, zo_lr=1e-8, engine="flat"),
                sgd(const_schedule(1e-2)), model_cfg=cfg, params_like=like)
            b = worker_rows(tree_map(torch.from_numpy, batch), mesh)
            args = (0 if kind == "fo" else 1, params, (), b)
            arguments = meter.held(args)
            meter.peak = meter.live
            coll.reset_gathers()
            ledger = CommLedger()
            ledger.wrap(kind, fo if kind == "fo" else zo)(*args)
        out[kind] = {"gathers": {k: list(v) for k, v in coll.GATHERS.items()},
                     "reduces": {k: list(v) for k, v in coll.REDUCES.items()},
                     "ledger": [(r.kind, r.nbytes) for r in ledger.programs[kind] if r.payload],
                     "peak": meter.peak, "arguments": arguments}
    return out


# --------------------------------------------------------------------------- #
# the partitioned forward: the spawned ranks of tests/test_torch_partitioned.py
# --------------------------------------------------------------------------- #
def _tokens(vocab, rows=4, seq=16, seed=0):
    import numpy as np

    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq))
    labels = np.concatenate([toks[:, 1:], -np.ones((rows, 1), np.int64)], 1)
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}


def loss_and_grads(cfg, params, batch, shards=None):
    """``(loss, gradient leaves, counts)`` of ``loss_fn`` on ``params``
    (this rank's shards with ``shards``); a leaf the loss does not reach
    gets a zero gradient.  The counts are the step's (``_counts``)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map

    p = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(p)
    coll.reset_gathers()
    loss = T.loss_fn(cfg, p, batch, shards)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (float(loss.detach()),
            [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)], _counts())


def partitioned_case(cfg, mesh, full, batch):
    """One rank's partitioned loss and gradient against the one-process ones
    on the whole parameters ``full``: both losses, per leaf the largest
    difference of this rank's gradient shard from its slice of the whole
    gradient over that slice's largest |g| (the tied embedding's: its
    rows), and the counts of the partitioned step (``_counts``)."""
    from repro_torch.dist.sharding import (
        ShardGeometry, ShardedParams, map_with_paths, param_specs, shard_tree)

    specs = param_specs(cfg, full, mesh)
    geom = ShardGeometry.from_global(specs, full, mesh)
    l1, g1, _ = loss_and_grads(cfg, full, batch)
    l2, g2, counts = loss_and_grads(cfg, shard_tree(full, specs, mesh), batch,
                                    ShardedParams(specs, mesh))
    paths = []
    map_with_paths(lambda names, x: paths.append(names), full)
    rel = {}
    for i, (a, b) in enumerate(zip(g2, g1)):
        want = b[geom.slices[i]]
        rel["/".join(paths[i])] = float((a - want).abs().max() / want.abs().max().clamp(min=1e-30))
    return {"loss": l2, "loss1": l1, "grad_rel": rel, **counts}


def rotated_sum():
    """A failing control: ``collectives.all_reduce_sum`` summing the parts
    from this rank's own, a different order on every rank."""
    import contextlib

    import torch.distributed as dist

    @contextlib.contextmanager
    def patched():
        real = coll.all_reduce_sum

        def all_reduce_sum(x, axes, *, mesh, label=None):
            parts = coll._gather_cat(x.unsqueeze(0), axes, mesh, 0)
            n = parts.shape[0]
            me = dist.get_rank(coll.axes_group(mesh, axes))
            out = parts[me].to(torch.float32)
            for r in range(1, n):
                out = out + parts[(me + r) % n].to(torch.float32)
            return out.to(x.dtype)

        coll.all_reduce_sum = all_reduce_sum
        try:
            yield
        finally:
            coll.all_reduce_sum = real

    return patched()


def _recorded(fn):
    """``(fn()'s result, records)``: the expert ids of every route it made
    (``models.moe.route``) and a digest of every all-reduce's result
    (``dist.sharding.ModelAxis.sum``: the replicated activations and
    gradients), in order, on this rank."""
    import hashlib

    from repro_torch.dist.sharding import ModelAxis
    from repro_torch.models import moe

    rec = {"ids": [], "sums": []}
    route, total = moe.route, ModelAxis.sum

    def recorded_route(cfg, p, xf):
        out = route(cfg, p, xf)
        rec["ids"].append(out[1].numpy().copy())
        return out

    def recorded_sum(self, x, label=None):
        out = total(self, x, label)
        rec["sums"].append(hashlib.sha1(out.detach().numpy().tobytes()).hexdigest())
        return out

    moe.route, ModelAxis.sum = recorded_route, recorded_sum
    try:
        return fn(), rec
    finally:
        moe.route, ModelAxis.sum = route, total


#: the SSM and hybrid architectures whose mamba mixer runs partitioned
SSM_ARCHS = ("falcon-mamba-7b", "hymba-1.5b")


def without_mixer_reduce():
    """A failing control: the partitioned mamba mixer's ``out_proj``
    all-reduce removed (each rank keeps its own partial), while the context
    is open."""
    import contextlib

    from repro_torch.models import ssm

    @contextlib.contextmanager
    def patched():
        real = ssm.mamba_forward

        def mamba_forward(cfg, p, x, tp=None):
            if tp is None:
                return real(cfg, p, x)
            return ssm._mamba_partial(cfg, p, tp.enter(x), tp).to(x.dtype)

        ssm.mamba_forward = mamba_forward
        try:
            yield
        finally:
            ssm.mamba_forward = real

    return patched()


def conv_w_not_entered():
    """A failing control: the replicated ``conv_w`` sliced to this rank's
    channels without ``ModelAxis.enter`` (its gradient one rank's share),
    while the context is open."""
    import contextlib

    from repro_torch.models import ssm

    @contextlib.contextmanager
    def patched():
        real = ssm._rank_channels

        def rank_channels(cfg, p, tp):
            local = real(cfg, p, tp)
            k = cfg.d_inner // tp.size
            local["conv_w"] = p["conv_w"].narrow(1, tp.rank * k, k)
            return local

        ssm._rank_channels = rank_channels
        try:
            yield
        finally:
            ssm._rank_channels = real

    return patched()


def ssm_steps(mesh, ssm_np, batch, m=2):
    """Per arch of ``SSM_ARCHS`` (its reduced config, the reference's
    parameters ``ssm_np[arch]``): an FO step (t=0) and a ZO step (t=ZO_T)
    of m workers on ``mesh``, with the digests of every all-reduce
    (``_recorded``)."""
    from repro_torch.configs import get_config

    out = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch).reduced()
        full, d = _full(ssm_np[arch])
        for kind, t in (("fo", 0), ("zo", ZO_T)):
            out[f"{arch}-{kind}"], out[f"{arch}-{kind}-records"] = _recorded(
                lambda: sharded_step(cfg, mesh, full, batch, llm_config(d, m), kind, t))
    return out


def run_partitioned_2(rank, world, qwen_np, batch, ssm_np):
    """(data=1, model=2): qwen3-14b reduced from the reference's parameters,
    an FO and a ZO step (m=4 held in the process) with their counts and the
    digests of every all-reduce (``_recorded``); the
    vocab-parallel cross-entropy of gemma2-2b reduced (tied embedding,
    vocabulary 512, 256 columns a rank) streamed at ``ce_chunk`` 96 and 100
    (256 not a multiple of either), dense (``ce_chunk`` -1) and dense on a
    rank while one process streams (300); a KV = 1 config whose ``wk``/``wv``
    cut falls inside a head; the gemma2 step without the MLP's all-reduce
    (the control); the SSM archs' steps (``ssm_steps``, m=2 held in the
    process), their loss and gradients against one process, and the same
    without the mixer's ``out_proj`` all-reduce and with ``conv_w`` not
    entered (the controls)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    mesh = make_test_mesh(data=1, model=2, device="cpu")
    qcfg = get_config("qwen3-14b").reduced()
    full, d = _full(qwen_np)
    out = {}
    for kind, t in (("fo", 0), ("zo", ZO_T)):
        out[kind], out[f"{kind}-records"] = _recorded(
            lambda: sharded_step(qcfg, mesh, full, batch, llm_config(d, 4), kind, t))
    gcfg = get_config("gemma2-2b").reduced()
    for chunk in (96, 100, -1, 300):
        cfg = gcfg.with_(ce_chunk=chunk)
        out[f"ce{chunk}"] = partitioned_case(cfg, mesh, T.init_model(0, cfg, device="cpu"),
                                             _tokens(cfg.vocab_size))
    kcfg = qcfg.with_(n_kv_heads=1)
    out["kv1"] = partitioned_case(kcfg, mesh, T.init_model(1, kcfg, device="cpu"),
                                  _tokens(kcfg.vocab_size))
    with without_mlp_reduce():
        out["no-mlp-reduce"] = partitioned_case(gcfg, mesh, T.init_model(0, gcfg, device="cpu"),
                                                _tokens(gcfg.vocab_size))
    out.update(ssm_steps(mesh, ssm_np, batch))
    for arch in SSM_ARCHS:
        cfg = get_config(arch).reduced()
        full = T.init_model(3, cfg, device="cpu")
        out[f"{arch}-grads"] = partitioned_case(cfg, mesh, full, _tokens(cfg.vocab_size))
        with without_mixer_reduce():
            out[f"{arch}-no-mixer-reduce"] = partitioned_case(cfg, mesh, full,
                                                              _tokens(cfg.vocab_size))
        with conv_w_not_entered():
            out[f"{arch}-conv-w-not-entered"] = partitioned_case(cfg, mesh, full,
                                                                 _tokens(cfg.vocab_size))
    return out


def run_partitioned_4(rank, world, moe_np, qwen_np, batch, ssm_np):
    """(data=2, model=2): qwen3-moe reduced under fsdp (one worker: every
    rank the whole batch), a ZO and an FO step with the expert ids of every
    route and the digests of every all-reduce (``_recorded``); the same
    config under ``moe_sharding='expert'`` against one process.  (data=1,
    model=4): qwen3-14b reduced, a ZO step (m=4 held in the process), then
    the same step with a rank-order-free sum (the control).  Then, on
    (data=2, model=2), the SSM archs' steps (``ssm_steps``, m=2)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    mesh = make_test_mesh(data=2, model=2, device="cpu")
    cfg = get_config("qwen3-moe-235b-a22b").reduced().with_(fsdp=True)
    full, d = _full(moe_np)
    out = {}
    for kind, t in (("zo", ZO_T), ("fo", 0)):
        out[kind], out[f"{kind}-records"] = _recorded(
            lambda: sharded_step(cfg, mesh, full, batch, llm_config(d, 1), kind, t))
    ecfg = get_config("qwen3-moe-235b-a22b").reduced().with_(moe_sharding="expert")
    out["expert"] = partitioned_case(ecfg, make_test_mesh(data=1, model=4, device="cpu"),
                                     T.init_model(2, ecfg, device="cpu"),
                                     _tokens(ecfg.vocab_size))
    qcfg = get_config("qwen3-14b").reduced()
    qfull, qd = _full(qwen_np)
    mesh4 = make_test_mesh(data=1, model=4, device="cpu")
    step = lambda: sharded_step(qcfg, mesh4, qfull, batch, llm_config(qd, 4), "zo",  # noqa: E731
                                ZO_T)
    out["model4"], out["model4-records"] = _recorded(step)
    with rotated_sum():
        out["model4-rotated"], out["model4-rotated-records"] = _recorded(step)
    out.update(ssm_steps(mesh, ssm_np, batch))
    return out


# --------------------------------------------------------------------------- #
# serving on sharded placements: the spawned ranks of
# tests/test_torch_sharded_serving.py
# --------------------------------------------------------------------------- #
#: case -> (arch, the reduced config's overrides): KV heads cut (dense GQA,
#: hymba, MoE), ``hd`` cut (hymba with 5 KV heads, its query heads parting a
#: group at model=2; and 5/5 heads, ``wq`` cut inside a head; and 10/5 with
#: ``attn_softcap``, tests/test_torch_kept_cut.py), d_inner cut
#: (falcon-mamba); ``-pallas``: the kernels' dispatch (their plain versions
#: on the CPU), the scan's final state in place of the recomputed tail
SERVE_CASES = {
    "dense": ("qwen3-14b", {"n_kv_heads": 2}),
    "dense-pallas": ("qwen3-14b", {"n_kv_heads": 2, "use_pallas": True}),
    "hymba": ("hymba-1.5b", {"n_layers": 4}),
    "hymba-hd": ("hymba-1.5b", {"n_layers": 4, "n_heads": 10, "n_kv_heads": 5}),
    "hymba-odd": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5}),
    "hymba-hd-cap": ("hymba-1.5b", {"n_layers": 4, "n_heads": 10, "n_kv_heads": 5,
                                    "attn_softcap": 50.0}),
    "falcon-mamba": ("falcon-mamba-7b", {}),
    "falcon-mamba-pallas": ("falcon-mamba-7b", {"use_pallas": True}),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
}
SERVE_STEPS = 3                  # decode steps after the prefill
SERVE_LEN = 64                   # the prefill's bucket


def serve_config(case):
    from repro_torch.configs import get_config

    arch, kw = SERVE_CASES[case]
    return get_config(arch).reduced().with_(remat=False, **kw)


def serve_prompts(cfg, seed=1):
    """``(tokens (2, SERVE_LEN), last)``: two prompts right-padded to the
    bucket (exact length for an SSM, which prefills unpadded)."""
    import numpy as np

    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, SERVE_LEN))
    last = [SERVE_LEN - 1] * 2 if cfg.has_ssm else [40, SERVE_LEN - 1]
    return torch.from_numpy(toks), torch.tensor(last)


def serve_run(cfg, params, shards=None, steps=SERVE_STEPS):
    """``prefill_at`` of ``serve_prompts``, its caches put in slots 0 and 2
    of a 3-slot pool (slot 1 inactive), then ``steps`` decode steps, each
    row fed its greedy token: the logits of the prefill and of every step
    (numpy), the prefill's caches and the pool at the end, and the
    collectives of the prefill and of the last decode step (``_counts``)."""
    from repro_torch.models import transformer as T

    toks, last = serve_prompts(cfg)
    with torch.no_grad():
        coll.reset_gathers()
        logits, caches = T.prefill_at(cfg, params, {"tokens": toks}, last, shards)
        prefill_counts = _counts()
        pool = T.init_caches(cfg, 3, SERVE_LEN + 8, torch.float32, device="cpu", shards=shards)
        for name, c in caches.items():
            for row, slot in ((0, 0), (1, 2)):
                pool[name][:, slot, :c.shape[2]] = c[:, row]
        pos = torch.tensor([int(last[0]) + 1, -1, int(last[1]) + 1], dtype=torch.int32)
        cur = torch.tensor([5, 0, 7])
        out = [logits.numpy()]
        for _ in range(steps):
            coll.reset_gathers()
            logits, pool = T.decode_step_slots(cfg, params, cur, pos, pool, shards)
            out.append(logits.numpy())
            cur = torch.where(pos >= 0, logits.argmax(-1), torch.zeros_like(cur))
            pos = torch.where(pos >= 0, pos + 1, -1).to(torch.int32)
    return {"logits": out, "caches": {k: v.numpy() for k, v in caches.items()},
            "pool": {k: v.numpy() for k, v in pool.items()}, "prefill_counts": prefill_counts,
            "decode_counts": _counts()}


def hd_cut(cfg, world) -> bool:
    """Whether ``cache_specs`` cuts the k/v cache over ``hd`` on model=``world``
    (an attention cache whose ``KV`` does not divide the axis, and ``hd``
    does)."""
    return cfg.has_attention and bool(cfg.n_kv_heads % world) and not cfg.head_dim % world


def inside_a_head(cfg, world) -> bool:
    """Whether model=``world`` cuts attention's ``wq`` or ``wk``/``wv`` inside
    a head (the columns of ``H`` or ``KV`` heads divide the axis, the heads
    do not)."""
    hd = cfg.head_dim
    return cfg.has_attention and any(n * hd % world == 0 and (n * hd // world) % hd
                                     for n in (cfg.n_heads, cfg.n_kv_heads))


def serve_collectives(cfg, kind, world):
    """(gathers, exchanges, all-reduces) over ``model`` of one prefill
    (``kind`` = "prefill") or decode step on (data=1, model=``world``), the
    hand count of the partitioned layers.  A layer: attention's all-reduce;
    where the axis cuts inside a head (``inside_a_head``) the q, k and v
    products gathered, no weight; at decode on an ``hd``-cut cache
    (``hd_cut``) also the attention output gathered and the partial logits
    all-reduced, no cache gathered.  The mamba mixer's exchange of u and z and its two
    all-reduces (``x_proj``, ``out_proj``), on the plain path's prefill
    once more each for the recomputed tail state (u alone).  The MLP's or
    experts' all-reduce.  Then the embedding's all-reduce and the logits'
    gather."""
    gathers, exchanges, reduces = 1, 0, 1
    plain_tail = kind == "prefill" and not (cfg.use_pallas and cfg.d_inner % 64 == 0)
    for _ in range(cfg.n_layers):
        if cfg.has_attention:
            reduces += 1
            gathers += 3 * inside_a_head(cfg, world)
            if kind == "decode" and hd_cut(cfg, world):
                gathers += 1
                reduces += 1
        if cfg.has_ssm:
            exchanges += 1 + plain_tail
            reduces += 2 + plain_tail
        reduces += bool(cfg.d_ff)
    return gathers, exchanges, reduces


def serve_collective_bytes(cfg, kind, world, rank, rows, seq, dtype_bytes=4):
    """The labelled collectives of ``serve_collectives`` on rank ``rank``,
    label -> [calls, bytes], for ``rows`` rows of ``seq`` tokens (one at
    decode, over a cache of ``seq`` positions): ``mixer_uz`` (the pieces the
    rank receives of u's and z's ``k = di/ms`` columns of its channels, its
    own excepted; the recomputed tail's u alone), ``logits`` (the whole
    vocabulary), where the axis cuts inside a head ``qkv`` (``B·S·H·hd``
    and twice ``B·S·KV·hd``, ``S`` = 1 at decode) and, at decode on an
    ``hd``-cut cache, ``partial_logits`` (``B·H·S`` float32) and
    ``attn_out`` (``B·H·hd`` float32)."""
    from repro_torch.models.ssm import uz_plan

    L, H, KV, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {"logits": [1, rows * cfg.vocab_size * dtype_bytes]}
    tokens = rows * (1 if kind == "decode" else seq)
    if cfg.has_ssm:
        k = cfg.d_inner // world
        tail = kind == "prefill" and not (cfg.use_pallas and cfg.d_inner % 64 == 0)
        pieces = sum(sum(src != rank for src, _, _ in uz_plan(world, k, parts)[rank])
                     for parts in ("uz", "u")[:1 + tail])
        out["mixer_uz"] = [L * (1 + tail), L * pieces * tokens * k * dtype_bytes]
    if inside_a_head(cfg, world):
        out["qkv"] = [3 * L, L * tokens * (H + 2 * KV) * hd * dtype_bytes]
    if kind == "decode" and hd_cut(cfg, world):
        out["partial_logits"] = [L, L * rows * H * seq * 4]
        out["attn_out"] = [L, L * rows * H * hd * 4]
    return out


def serve_generate(cfg, params, shards=None):
    """``Engine.generate`` of three prompts through 2 slots, 5 new tokens."""
    import numpy as np

    from repro_torch.serving import Engine, ServeConfig

    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in (5, 12, 9)]
    eng = Engine(cfg, params, ServeConfig(max_seq=32, slots=2), shards=shards)
    with torch.no_grad():
        return eng.generate(prompts, 5)


def without_attention_reduce():
    """A failing control: the partitioned attention's all-reduce removed
    (each rank keeps its own partial of ``wo``) while the context is open."""
    import contextlib

    from repro_torch.dist.sharding import row_partial
    from repro_torch.models import attention

    def out(self, o):
        if self.every_head:
            o = self.tp.split(o, -1)
        return row_partial(o, self.wo).to(self.dtype)

    @contextlib.contextmanager
    def patched():
        real = attention._RankProjection.out
        attention._RankProjection.out = out
        try:
            yield
        finally:
            attention._RankProjection.out = real

    return patched()


def cache_wrong_heads():
    """A failing control: each rank writes its k/v cache with its KV heads
    rotated by one (each head's rows under the next head) while the context
    is open."""
    import contextlib

    from repro_torch.models import attention

    @contextlib.contextmanager
    def patched():
        real = attention._RankProjection.cached
        attention._RankProjection.cached = lambda self, t: torch.roll(real(self, t), 1, dims=2)
        try:
            yield
        finally:
            attention._RankProjection.cached = real

    return patched()


def run_serving(rank, world, ref_np, cases, generate):
    """(data=1, model=world): per case of ``SERVE_CASES`` in ``cases``, the
    reference's parameters ``ref_np[case]`` cut into this rank's shards and
    served (``serve_run``); for the cases in ``generate``,
    ``Engine.generate`` on the shards (``serve_generate``); on model=2 the
    two controls on qwen3-14b reduced (4 KV heads, 2 a rank)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import ShardedParams, param_specs, shard_tree

    torch.set_num_threads(1)
    mesh = make_test_mesh(data=1, model=world, device="cpu")
    out = {}
    for case in cases:
        cfg = serve_config(case)
        full = params_from_numpy(ref_np[case], device="cpu")
        specs = param_specs(cfg, full, mesh)
        shards, gathered = shard_tree(full, specs, mesh), ShardedParams(specs, mesh)
        out[case] = serve_run(cfg, shards, gathered)
        out[case]["held"] = {k: tuple(v.shape) for k, v in out[case]["pool"].items()}
        if case in generate:
            out[f"{case}-generate"] = serve_generate(cfg, shards, gathered)
    if world == 2:
        cfg = serve_config("dense").with_(n_kv_heads=4)
        full = params_from_numpy(ref_np["mha"], device="cpu")
        specs = param_specs(cfg, full, mesh)
        shards, gathered = shard_tree(full, specs, mesh), ShardedParams(specs, mesh)
        for name, control in (("no-attention-reduce", without_attention_reduce),
                              ("cache-wrong-heads", cache_wrong_heads)):
            with control():
                out[name] = serve_run(cfg, shards, gathered)
    return out


# --------------------------------------------------------------------------- #
# the sequence-sharded decode (long_500k): the spawned ranks of
# tests/test_torch_long_context.py
# --------------------------------------------------------------------------- #
#: case -> (arch, the reduced config's overrides): the archs of
#: ``long_500k``, dense (gemma2-2b, starcoder2-3b with 2 KV heads), hybrid
#: (hymba-1.5b) and SSM (falcon-mamba-7b); ``hymba-hd``: 10/5 heads, whose
#: cache the ``model`` axis cuts over ``hd`` (gathered at each read)
LONG_CASES = {"gemma2-2b": ("gemma2-2b", {}), "starcoder2-3b": ("starcoder2-3b", {}),
              "hymba-1.5b": ("hymba-1.5b", {}), "falcon-mamba-7b": ("falcon-mamba-7b", {}),
              "hymba-hd": ("hymba-1.5b", {"n_heads": 10, "n_kv_heads": 5})}
LONG_S, LONG_W = 256, 32          # the cache's rows, every attention layer's window
#: the decode's positions in turn: a window straddling the boundary of rows
#: 128 (and its next position), one inside rank 0's rows, the last row
LONG_POSITIONS = (143, 144, 40, LONG_S - 1)
#: meshes of the spawned groups: (data, model)
LONG_MESHES = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}


def long_config(case):
    """The case's arch reduced in float32, every attention layer windowed at
    ``LONG_W`` (``long_context``, as ``config_for_shape`` gives ``long_500k``)."""
    from repro_torch.configs import get_config

    arch, kw = LONG_CASES[case]
    return get_config(arch).reduced().with_(remat=False, long_context=True, window=LONG_W, **kw)


def long_inputs(cfg, seed=0):
    """``(whole caches, tokens)`` as numpy: every cache leaf of one row and
    ``LONG_S`` positions drawn from ``seed`` (the ssm state at 0.1), one
    token a position of ``LONG_POSITIONS``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L, out = cfg.n_layers, {}
    if cfg.has_attention:
        for name in ("k", "v"):
            out[name] = rng.standard_normal(
                (L, 1, LONG_S, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    if cfg.has_ssm:
        out["conv"] = rng.standard_normal((L, 1, cfg.ssm_conv - 1, cfg.d_inner)).astype(
            np.float32)
        out["ssm"] = 0.1 * rng.standard_normal((L, 1, cfg.d_inner, cfg.ssm_state)).astype(
            np.float32)
    return out, rng.integers(0, cfg.vocab_size, len(LONG_POSITIONS))


def long_run(cfg, params, caches_np, tokens, shards=None):
    """``serve_step`` at each of ``LONG_POSITIONS`` in turn from the caches
    ``caches_np`` (this rank's slices of them with ``shards``): the logits
    of every step, the caches at the end and the all-reduces of every step
    (``collectives.REDUCES``)."""
    from repro_torch.dist.sharding import cache_slices
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import serve_step

    caches = T.init_caches(cfg, 1, LONG_S, torch.float32, device="cpu", shards=shards)
    if shards is not None:
        cut = cache_slices(cfg, shards.mesh, {k: torch.empty(v.shape, device="meta")
                                              for k, v in caches_np.items()},
                           seq_sharded=shards.seq is not None)
    for name, c in caches.items():
        whole = torch.from_numpy(caches_np[name])
        c.copy_(whole if shards is None else whole[cut[name]])
    logits, reduces = [], []
    with torch.no_grad():
        for pos, tok in zip(LONG_POSITIONS, tokens):
            coll.reset_gathers()
            lg, caches = serve_step(cfg, params, torch.tensor([int(tok)]), pos, caches, shards)
            logits.append(lg.numpy().copy())
            reduces.append({k: list(v) for k, v in coll.REDUCES.items()})
    return {"logits": logits, "caches": {k: v.numpy() for k, v in caches.items()},
            "reduces": reduces, "held": {k: tuple(v.shape) for k, v in caches.items()}}


def unscaled_softmax_sum():
    """A failing control: each rank's partial normalised by its own sum and
    the ranks' outputs summed, without the rescale to the global max."""
    import contextlib

    from repro_torch.models import attention

    @contextlib.contextmanager
    def patched():
        real = attention._combine_partials
        attention._combine_partials = lambda parts, hd: (
            parts[..., :hd] / parts[..., hd + 1:hd + 2]).sum(0)
        try:
            yield
        finally:
            attention._combine_partials = real

    return patched()


def write_without_offset():
    """A failing control: the new row written at local row ``pos`` (without
    the ``- r0`` offset) by every rank whose slice has such a row."""
    import contextlib

    from repro_torch.models import attention

    def write(cache, new, pos, r0):
        if pos < cache.shape[1]:
            cache[:, pos] = new[:, 0].to(cache.dtype)

    @contextlib.contextmanager
    def patched():
        real = attention._write_row
        attention._write_row = write
        try:
            yield
        finally:
            attention._write_row = real

    return patched()


def run_long(rank, world, ref_np):
    """Per mesh of ``LONG_MESHES[world]`` and case of ``LONG_CASES``: the
    reference's parameters ``ref_np[case]`` cut into this rank's shards,
    served on sequence-sharded caches (``long_run``); on (data=2) the two
    controls on gemma2-2b."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import ShardedParams, param_specs, shard_tree

    torch.set_num_threads(1)
    out = {}
    for data, model in LONG_MESHES[world]:
        mesh = make_test_mesh(data=data, model=model, device="cpu")
        for case in LONG_CASES:
            cfg = long_config(case)
            full = params_from_numpy(ref_np[case], device="cpu")
            specs = param_specs(cfg, full, mesh)
            shards = ShardedParams(specs, mesh, seq_sharded=True)
            out[data, model, case] = long_run(cfg, shard_tree(full, specs, mesh),
                                              *long_inputs(cfg), shards)
        if (data, model) == (2, 1):
            cfg = long_config("gemma2-2b")
            full = params_from_numpy(ref_np["gemma2-2b"], device="cpu")
            shards = ShardedParams(param_specs(cfg, full, mesh), mesh, seq_sharded=True)
            for name, control in (("unscaled", unscaled_softmax_sum),
                                  ("no-offset", write_without_offset)):
                with control():
                    out[name] = long_run(cfg, full, *long_inputs(cfg), shards)
    return out


# --------------------------------------------------------------------------- #
# the kept cut (in_proj and the hd-cut cache): the spawned ranks of
# tests/test_torch_kept_cut.py
# --------------------------------------------------------------------------- #
#: meshes of the kept-cut groups by world size: (data, model)
KEPT_MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
#: the hd-cut serving cases (``SERVE_CASES``) and the mixer's
KEPT_HD = ("hymba-hd", "hymba-odd", "hymba-hd-cap")
KEPT_MIXER = ("falcon-mamba", "hymba")
#: the scalar decode's fed tokens a step, one a row (``scalar_run``)
SCALAR_TOKENS = ((5, 7), (11, 3), (2, 9))


def exchange_plans(world):
    """name -> (plan, x's shape, dim) of ``collectives.exchange`` on
    ``world`` ranks: the mixer's u/z plan (``uz_plan``, k = 3) on the last
    dim, and on dim 1 a plan of pieces of several lengths, from the rank
    itself, twice from one source, and (on 4 ranks) a rank that takes only
    its own piece, so receives nothing."""
    from repro_torch.models.ssm import uz_plan

    mixed = tuple(((d, 0, 2),) if world > 2 and d == world - 1 else
                  ((d, 0, 2), ((d + 1) % world, 3, 4), ((d + 1) % world, 1, 1),
                   ((d + world - 1) % world, 7, 3)) for d in range(world))
    return {"uz": (uz_plan(world, 3), (2, 4, 6), -1), "mixed": (mixed, (3, 10, 2), 1)}


def exchange_inputs(rank, shape, plan, seed=0):
    """Rank ``rank``'s ``x`` and, per piece of its plan, the weights of the
    piece's gradient (float32 draws of ``seed``, repeated to the piece's
    shape by ``np.resize``)."""
    import numpy as np

    rng = np.random.default_rng([seed, rank])
    x = rng.standard_normal(shape).astype(np.float32)
    return x, [rng.standard_normal(7).astype(np.float32) for _ in plan[rank]]


def run_exchange(mesh, world, rank):
    """Per plan of ``exchange_plans``: this rank's pieces (``exchange``) and
    the counted exchanges; the same pieces through ``ModelAxis.exchange``,
    and the gradient of ``sum_i (piece_i * w_i).sum()`` (``w_i`` repeated
    to each piece's shape) for this rank's ``x`` through its backward, the
    transposed exchange, with that backward's counts."""
    import numpy as np

    from repro_torch.dist.sharding import ModelAxis

    axis, out = ModelAxis(mesh), {}
    for name, (plan, shape, dim) in exchange_plans(world).items():
        x_np, ws = exchange_inputs(axis.rank, shape, plan)
        x = torch.from_numpy(x_np)
        coll.reset_gathers()
        pieces = coll.exchange(x, plan, "model", mesh=mesh, dim=dim, label=name)
        r = {"pieces": [p.numpy() for p in pieces], "counts": _counts()}
        grads = [torch.from_numpy(np.resize(w, p.shape)) for p, w in zip(pieces, ws)]
        xg = x.clone().requires_grad_(True)
        got = axis.exchange(xg, plan, dim, label=name)
        r["same"] = all(torch.equal(a, b) for a, b in zip(pieces, got))
        loss = sum((p * g).sum() for p, g in zip(got, grads))
        coll.reset_gathers()
        loss.backward()
        r["grad"], r["grad_counts"] = xg.grad.numpy(), _counts()
        out[name] = r
    return out


def scalar_run(cfg, params, shards=None, steps=len(SCALAR_TOKENS)):
    """``prefill_at`` of ``serve_prompts`` at their last position, its
    caches in a pool of ``SERVE_LEN + 8`` rows, then ``serve_step`` at one
    position for both rows, fed ``SCALAR_TOKENS``: the logits of every step
    and the collectives of the last (``_counts``)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import serve_step

    toks, _ = serve_prompts(cfg)
    last = torch.full((2,), SERVE_LEN - 1)
    with torch.no_grad():
        _, caches = T.prefill_at(cfg, params, {"tokens": toks}, last, shards)
        pool = T.init_caches(cfg, 2, SERVE_LEN + 8, torch.float32, device="cpu", shards=shards)
        for name, c in caches.items():
            pool[name][:, :, :c.shape[2]] = c
        out = []
        for step in range(steps):
            coll.reset_gathers()
            logits, pool = serve_step(cfg, params, torch.tensor(SCALAR_TOKENS[step]),
                                      SERVE_LEN + step, pool, shards)
            out.append(logits.numpy())
    return {"logits": out, "counts": _counts()}


def uz_swapped():
    """A failing control: the mixer's exchange plan with u's and z's
    sources swapped (each rank takes z's piece as its u and u's as its z)
    while the context is open."""
    import contextlib

    from repro_torch.models import ssm

    @contextlib.contextmanager
    def patched():
        real = ssm.uz_plan
        ssm.uz_plan = lambda ms, k, parts="uz": real(ms, k, parts[::-1])
        try:
            yield
        finally:
            ssm.uz_plan = real

    return patched()


def _hd_logits(mutate):
    """A failing control: ``attention._logits`` on an ``hd``-cut decode
    with ``mutate(cfg, partial float32 products, hd_axis)`` in place of the
    sum over the axis, the scale and the softcap, while the context is
    open."""
    import contextlib

    from repro_torch.models import attention

    @contextlib.contextmanager
    def patched():
        real = attention._logits

        def logits(cfg, q, k, q_positions, k_positions, window, causal, hd_axis=None):
            if hd_axis is None:
                return real(cfg, q, k, q_positions, k_positions, window, causal)
            B, Sq, H, hd = q.shape
            qg = q.reshape(B, Sq, k.shape[2], H // k.shape[2], hd).to(torch.float32)
            part = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(torch.float32))
            return attention._masked(mutate(cfg, part, hd_axis), q_positions, k_positions,
                                     window, causal)

        attention._logits = logits
        try:
            yield
        finally:
            attention._logits = real

    return patched()


def softcap_before_sum():
    """A failing control: each rank's partial logits scaled and soft-capped
    before the sum over the axis."""
    import math

    from repro_torch.models.layers import softcap

    def mutate(cfg, part, axis):
        part = part / math.sqrt(cfg.head_dim)
        return axis.sum(softcap(part, cfg.attn_softcap) if cfg.attn_softcap else part)

    return _hd_logits(mutate)


def slice_scaled():
    """A failing control: the summed logits scaled by ``sqrt(hd/ms)``, the
    rank's slice, in place of the whole head's ``sqrt(hd)``."""
    import math

    from repro_torch.models.layers import softcap

    def mutate(cfg, part, axis):
        logits = axis.sum(part) / math.sqrt(cfg.head_dim // axis.size)
        return softcap(logits, cfg.attn_softcap) if cfg.attn_softcap else logits

    return _hd_logits(mutate)


#: the training configs whose ``model`` cut falls inside a head, by name:
#: hymba-1.5b reduced at 10/5 heads (``wk``/``wv`` cut inside a head on
#: model=2, ``wq`` too on model=4), at 5/5 (``wq`` cut inside a head) and
#: qwen3-14b reduced with one KV head (``wq`` on whole heads, ``wk``/``wv``
#: inside one)
HEAD_CUT = {"hymba-hd": ("hymba-1.5b", {"n_heads": 10, "n_kv_heads": 5}),
            "hymba-odd": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5}),
            "kv1": ("qwen3-14b", {"n_kv_heads": 1})}


def head_cut_config(case):
    from repro_torch.configs import get_config

    arch, kw = HEAD_CUT[case]
    return get_config(arch).reduced().with_(**kw)


def head_cut_gathers(cfg, rows, seq, forwards=1, backwards=0, dtype_bytes=4, layers=None):
    """The gathers over ``model`` of ``forwards`` forwards and ``backwards``
    backwards of ``layers`` (default all) attention layers that the axis
    cuts inside a head, label -> [calls, bytes]: a layer's forward gathers
    the q, k and v products (``B·S·H·hd`` and twice ``B·S·KV·hd`` elements,
    ``qkv``), its backward the attention output's gradient (``B·S·H·hd``,
    ``attn_out_grad``)."""
    L, H, KV, hd = layers or cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tokens = rows * seq
    out = {"qkv": [3 * L * forwards, L * forwards * tokens * (H + 2 * KV) * hd * dtype_bytes]}
    if backwards:
        out["attn_out_grad"] = [L * backwards, L * backwards * tokens * H * hd * dtype_bytes]
    return out


def recorded_collectives():
    """A context that records ``(kind, shape)`` of every all-gather (its
    result) and all-reduce (its operand) over the group, in call order,
    into the list it yields."""
    import contextlib

    @contextlib.contextmanager
    def patched():
        seen, gather, reduce = [], coll.gather_cat, coll.all_reduce_sum

        def gather_cat(x, axes, **kw):
            out = gather(x, axes, **kw)
            seen.append(("all-gather", tuple(out.shape)))
            return out

        def all_reduce_sum(x, axes, **kw):
            seen.append(("all-reduce", tuple(x.shape)))
            return reduce(x, axes, **kw)

        coll.gather_cat, coll.all_reduce_sum = gather_cat, all_reduce_sum
        try:
            yield seen
        finally:
            coll.gather_cat, coll.all_reduce_sum = gather, reduce

    return patched()


def split_only_slices():
    """A failing control: ``ModelAxis.split`` whose backward only slices
    (``narrow``: the gradient of this rank's columns, zeros elsewhere, no
    gather), while the context is open."""
    import contextlib

    from repro_torch.dist.sharding import ModelAxis

    @contextlib.contextmanager
    def patched():
        real = ModelAxis.split

        def split(self, x, dim, label=None):
            n = x.shape[dim] // self.size
            return x.narrow(dim, self.rank * n, n)

        ModelAxis.split = split
        try:
            yield
        finally:
            ModelAxis.split = real

    return patched()


def attention_run(cfg, p_np, x_np, mesh=None):
    """hymba-1.5b's attention on ``x_np`` from the whole parameters ``p_np``
    (numpy), in one process or, with ``mesh``, on this rank's shards
    partitioned over its ``model`` axis: ``attention_forward``,
    ``attention_prefill`` (output and cache) and the gradient of the
    forward's sum w.r.t. the parameters (this rank's shards) and x, with the
    collectives of each (``recorded_collectives``; the gradient's forward
    and backward apart) and the counts of the gradient's forward and
    backward (``_counts``)."""
    from repro_torch.dist.sharding import ModelAxis, param_specs, shard_tree
    from repro_torch.models import attention as A

    p = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    tp = None
    if mesh is not None:
        p = shard_tree(p, param_specs(cfg, {"attn": p}, mesh)["attn"], mesh)
        tp = ModelAxis(mesh)
    x = torch.from_numpy(x_np)
    out = {}
    with torch.no_grad(), recorded_collectives() as seen:
        out["forward"] = A.attention_forward(cfg, p, x, tp=tp).numpy()
    out["forward_collectives"] = seen
    with torch.no_grad(), recorded_collectives() as seen:
        y, (k, v) = A.attention_prefill(cfg, p, x, tp=tp)
    out.update(prefill=y.numpy(), k=k.numpy(), v=v.numpy(), prefill_collectives=seen)
    pg = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xg = x.clone().requires_grad_(True)
    coll.reset_gathers()
    with recorded_collectives() as seen:
        y = A.attention_forward(cfg, pg, xg, tp=tp)
    out["grad_forward_collectives"], out["grad_forward_counts"] = seen, _counts()
    coll.reset_gathers()
    with recorded_collectives() as seen:
        grads = torch.autograd.grad(y.sum(), [*pg.values(), xg])
    out["backward_collectives"], out["backward_counts"] = seen, _counts()
    out["grads"] = {n: g.numpy() for n, g in zip([*pg, "x"], grads)}
    return out


def run_kept_cut(rank, world, ssm_np, batch, serve_np, attn_np):
    """Per mesh of ``KEPT_MESHES[world]``: the exchanges (``run_exchange``;
    (data=1) meshes only); the SSM archs' loss and gradients against one
    process (``partitioned_case``) and, on (data=1, model=4), their FO and
    ZO steps (``ssm_steps``, m=2); on (data=1) meshes the ``HEAD_CUT``
    configs' loss and gradients against one process (``partitioned_case``)
    and the serving cases ``KEPT_MIXER`` and ``KEPT_HD`` from the
    reference's parameters (``serve_run``, and ``scalar_run`` for the
    hd-cut ones).  On model=2 hymba-1.5b's attention at full width on
    ``attn_np`` = (parameters, x) (``attention_run``) and the controls:
    ``uz_swapped`` (falcon-mamba served, and hymba's loss),
    ``softcap_before_sum`` (hymba-hd-cap), ``slice_scaled`` (hymba-hd) and
    ``split_only_slices`` (the full-width attention's gradient)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import ShardedParams, param_specs, shard_tree
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    out = {}
    for data, model in KEPT_MESHES[world]:
        mesh = make_test_mesh(data=data, model=model, device="cpu")
        key = f"{data}x{model}"
        for arch in SSM_ARCHS:
            cfg = get_config(arch).reduced()
            out[key, arch, "grads"] = partitioned_case(cfg, mesh, T.init_model(3, cfg,
                                                                               device="cpu"),
                                                       _tokens(cfg.vocab_size))
        if (data, model) == (1, 4):
            out[key, "steps"] = ssm_steps(mesh, ssm_np, batch)
        if data != 1:
            continue
        out[key, "exchange"] = run_exchange(mesh, world, rank)
        for case in HEAD_CUT:
            cfg = head_cut_config(case)
            out[key, case, "grads"] = partitioned_case(
                cfg, mesh, T.init_model(5, cfg, device="cpu"), _tokens(cfg.vocab_size))
        if model == 2:
            acfg = get_config("hymba-1.5b")
            out["attention"] = attention_run(acfg, *attn_np, mesh)
            with split_only_slices():
                out["split-only-slices"] = attention_run(acfg, *attn_np, mesh)
        served = {}
        for case in KEPT_MIXER + KEPT_HD:
            cfg = serve_config(case)
            full = params_from_numpy(serve_np[case], device="cpu")
            specs = param_specs(cfg, full, mesh)
            served[case] = (cfg, shard_tree(full, specs, mesh), ShardedParams(specs, mesh))
            out[key, case] = serve_run(*served[case])
            if case in KEPT_HD:
                out[key, case, "scalar"] = scalar_run(*served[case])
        if model == 2:
            with uz_swapped():
                out["uz-swapped"] = serve_run(*served["falcon-mamba"])
                cfg = get_config("hymba-1.5b").reduced()
                out["uz-swapped-grads"] = partitioned_case(
                    cfg, mesh, T.init_model(3, cfg, device="cpu"), _tokens(cfg.vocab_size))
            with softcap_before_sum():
                out["softcap-before-sum"] = scalar_run(*served["hymba-hd-cap"])
            with slice_scaled():
                out["slice-scaled"] = scalar_run(*served["hymba-hd"])
    return out


def card_exchange(rank, world):
    """``ModelAxis.exchange`` and its backward between ranks that
    share ``cuda:0`` (the same-card exchange), on ``exchange_plans``' plans
    in bf16 and float32: the pieces and the gradients' sums at the owners,
    and whether the card path ran."""
    import numpy as np

    from repro_torch.dist.sharding import ModelAxis

    torch.cuda.set_device(0)
    mesh = make_test_mesh(data=1, model=world, device="cuda")
    axis, out = ModelAxis(mesh), {}
    for name, (plan, shape, dim) in exchange_plans(world).items():
        x_np, ws = exchange_inputs(rank, shape, plan)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(x_np).to("cuda", dt).requires_grad_(True)
            pieces = axis.exchange(x, plan, dim)
            grads = [torch.from_numpy(np.resize(w, p.shape)).to("cuda", dt)
                     for p, w in zip(pieces, ws)]
            torch.autograd.backward(pieces, grads)
            out[name, str(dt)] = {"pieces": [p.detach().float().cpu().numpy() for p in pieces],
                                  "grad": x.grad.float().cpu().numpy()}
    out["card"] = coll._CARDS[mesh][("model",)] is not None
    return out
