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

from repro_torch.core.distributed import make_distributed_ho_sgd, make_fo_step, make_zo_step
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
    from repro_torch.dist.sharding import P, ShardedParams, gather_tree, shard_tree

    out = {}
    for case, spec, fsdp in (("model", P("model"), False), ("fsdp", P("data"), True)):
        specs = {"x": spec}
        gathered = ShardedParams({"layers": {}, **specs}, mesh)
        loss = lambda p, b: quad_loss({"x": gathered.top("x", p["x"])}, b)  # noqa: E731
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


def sharded_step(cfg, mesh, full, batch, ho, kind, t, **kw):
    """One FO or ZO step of ``make_distributed_ho_sgd`` on this rank's
    shards: the gathered parameters (numpy, on rank 0), their checksum, the
    shapes held, the loss, this rank's first loss evaluation (its f0 on a
    ZO step), the ledger's bytes and this rank's rows."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import gather_tree
    from repro_torch.tree import tree_leaves

    shards, specs, loss, losses = sharded_model(cfg, mesh, full)
    fo, zo = make_distributed_ho_sgd(loss, mesh, ho, model_cfg=cfg, params_like=full, **kw)
    ledger = CommLedger()
    step = ledger.wrap(kind, fo if kind == "fo" else zo)
    b = next(iter(shard_batches(iter([batch]), mesh, whole=cfg.fsdp)))
    p, _, out = step(t, shards, (), b)
    whole = [x.numpy() for x in tree_leaves(gather_tree(p, specs, mesh))]
    return {"params": whole if dist.get_rank() == 0 else None,
            "checksum": float(sum(x.astype("float64").sum() for x in whole)),
            "held": [tuple(x.shape) for x in tree_leaves(p)], "loss": float(out),
            "f0": losses[0], "bytes": ledger.bytes_per_step(kind),
            "kinds": ledger.by_kind(kind), "rows": b["tokens"].numpy().copy()}


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


def run_sharded_2(rank, world, full_np, batch, quad_batch):
    """(data=1, model=2): the FO step of qwen3-14b reduced (m=4 held in the
    process), and the pallas engine's per-run branch on a (3, 8, 6) leaf
    cut on dim 1 (three runs) against the tree engine."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import P, ShardedParams, gather_tree, shard_tree

    torch.set_num_threads(1)
    cfg = get_config("qwen3-14b").reduced()
    full, d = _full(full_np)
    mesh = make_test_mesh(data=1, model=2, device="cpu")
    out = {"fo": sharded_step(cfg, mesh, full, batch, llm_config(d, 4), "fo", 0)}
    specs = {"w": P(None, "model")}
    gathered = ShardedParams({"layers": {}, **specs}, mesh)
    loss = lambda p, b: quad_rows({"w": gathered.top("w", p["w"])}, b)  # noqa: E731
    w = torch.linspace(-1.0, 1.0, 144).reshape(3, 8, 6)
    for engine in ("pallas", "tree"):
        ho = HOSGDConfig(tau=4, mu=1e-3, m=2, lr=0.1, zo_lr=0.05, engine=engine)
        zo = make_zo_step(loss, mesh, ho, sgd(const_schedule(0.05)), param_specs_tree=specs)
        p, _, l = zo(1, shard_tree({"w": w}, specs, mesh), (), quad_batch)
        out[f"quad-{engine}"] = {"w": gather_tree(p, specs, mesh)["w"].numpy(),
                                 "loss": float(l)}
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
