"""What the spawned ranks of tests/test_torch_distributed.py run.

A module of its own, imported by the children as a top-level module (the
test file imports jax; the ranks need torch and the port only).  Every rank
builds the same meshes over the group it joined, runs each case's steps on
its own rows (``data.pipeline.shard_batches``) and returns what the test
compares: losses, final parameters, the ledger's bytes and the rows it got.
"""
import torch

from repro_torch.core.distributed import make_distributed_ho_sgd
from repro_torch.core.ho_sgd import HOSGDConfig
from repro_torch.data.pipeline import shard_batches, take
from repro_torch.dist import CommLedger, collectives as coll
from repro_torch.dist.compress import qsgd
from repro_torch.dist.sharding import worker_index
from repro_torch.launch.mesh import make_test_mesh

TAU = 4
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
    return out

