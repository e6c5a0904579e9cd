"""The port's simulator (``repro_torch.sim``) against the reference's, and
its contracts in the port alone.

Against the reference (``torch_sim_helpers`` holds the set-up and the rules:
exact traces and bytes, losses to rtol 1e-4, parameters by the ROADMAP's
rules): the synchronous cluster, stragglers with jitter and persistent
heterogeneous speeds, HO-SGD in both replay modes and on both engines.  The
other scenarios and methods are in ``test_torch_sim_{faults,async,methods,
federated}.py``.

In the port alone: a spec run twice gives a bit-identical trace, losses and
parameters (the flat engine's plain kernels); stale views survive a bulk
rollback and staleness and elastic membership move the per-worker replay's
trajectory only (tests/test_replay_fidelity.py); no step writes the
parameters, state or views it was handed, the fused flat round included;
the byte contracts of tests/test_replay_fidelity.py:161-202; the 1x1 mesh's
world-size-1 group is made and destroyed, a caller's group kept.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.sim as S
import torch_sim_helpers as H
from repro.data.synthetic import batches as jbatches
from repro_torch.convert import params_from_numpy
from repro_torch.dist import compress as C
from repro_torch.models.mlp import mlp_loss
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def reference_auto_branch(monkeypatch):
    H.reference_auto_branch(monkeypatch)


@pytest.fixture(scope="module")
def problem():
    return H.make_problem()


@pytest.mark.parametrize("case", H.CASES["test_torch_sim"], ids=H.case_id)
def test_simulate_matches_reference(problem, monkeypatch, case):
    H.check_against_reference(problem, monkeypatch, case)


# --------------------------------------------------------------------------- #
# the port alone
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scenario,which", [("elastic", "ho_sgd"), ("stale2", "ho_sgd"),
                                            ("failure", "ho_sgd"),
                                            ("federated", "fed_ho_sgd")])
def test_same_spec_bit_identical(problem, monkeypatch, scenario, which):
    """The determinism contract on the port, with the flat kernels' plain
    versions: the same spec twice gives the same trace, losses and
    parameters, bit for bit; another seed another trace."""
    r1, r2 = (H.run_port(problem, scenario, which, "per_worker", "flat") for _ in range(2))
    assert r1.trace == r2.trace and r1.times == r2.times and r1.losses == r2.losses
    assert r1.evals == r2.evals and r1.active_counts == r2.active_counts
    for a, b in zip(tree_leaves(r1.params), tree_leaves(r2.params)):
        assert torch.equal(a, b)
    if "seed" in H.SCENARIOS[scenario]:          # the draws follow the spec's seed
        moved = dict(H.SCENARIOS[scenario], seed=H.SCENARIOS[scenario]["seed"] + 1)
        monkeypatch.setitem(H.SCENARIOS, scenario, moved)
        assert H.run_port(problem, scenario, which, "per_worker", "flat").trace != r1.trace


def quad_loss(params, batch):
    return 0.5 * torch.mean(torch.sum((params["x"] - batch["t"]) ** 2, -1))


def quad_batches():
    i = 0
    while True:
        yield {"t": np.full((2 * H.M, 48), 1.0 + 0.1 * (i % 7), np.float32)}
        i += 1


QBASE = S.ClusterSpec(m=H.M, flops_per_sec=1e9, bandwidth=1e6, seed=0)
QHETERO = QBASE.with_(rel_speeds=(1.0, 1.0, 1.0, 0.25), max_staleness=2)
QELASTIC = QBASE.with_(elastic=True, fail_rate=5000.0, downtime=5e-5, restart_time=1e-5,
                       jitter_sigma=0.1)


def qrun(spec, replay, which="ho_sgd", n=12, codec=None, compress_mode="per_worker",
         engine="tree"):
    """tests/test_replay_fidelity.py's problem on the port."""
    params = {"x": torch.zeros(48)}
    sm = S.make_sim_methods(quad_loss, params, spec, tau=H.TAU, lr=0.1, zo_lr=0.05,
                            codec=codec, compress_mode=compress_mode, engine=engine,
                            which=[which])[which]
    return S.simulate(sm, params, quad_batches(), spec, n,
                      compute=S.compute_model_for(params, spec, 2), replay=replay)


def test_staleness_views_survive_bulk_rollback():
    """After a bulk-synchronous restore, view selection indexes the current
    lineage's commits: stale views still change the trajectory in the
    rounds committed after the last restore, deterministically."""
    spec = QHETERO.with_(fail_rate=500.0, ckpt_every=2, restart_time=1e-4, seed=3)
    pw, mono = qrun(spec, "per_worker", n=24), qrun(spec, "monolithic", n=24)
    assert pw.failures > 0 and pw.trace == mono.trace
    last_restore = max(t for t, k, _ in pw.trace if k == "restore")
    post = [i for i, tm in enumerate(pw.times) if tm > last_restore]
    assert post and any(pw.losses[i] != mono.losses[i] for i in post)
    again = qrun(spec, "per_worker", n=24)
    assert pw.trace == again.trace and pw.losses == again.losses


def test_membership_and_staleness_change_the_trajectory_per_worker_only():
    """tests/test_replay_fidelity.py's divergence pins: the per-worker
    replay's trajectory moves with staleness and elastic membership, the
    monolithic replay's does not; pricing is the same in both modes."""
    pw, mono = qrun(QHETERO, "per_worker"), qrun(QHETERO, "monolithic")
    assert mono.losses == qrun(QHETERO.with_(max_staleness=0), "monolithic").losses
    assert pw.trace == mono.trace and pw.losses != mono.losses
    still = QBASE.with_(max_staleness=2, contention=False)
    assert qrun(still, "per_worker").losses == qrun(still, "monolithic").losses
    el, ref = qrun(QELASTIC, "per_worker"), QELASTIC.with_(fail_rate=0.0, elastic=False)
    assert el.failures > 0 and min(el.active_counts) < H.M
    assert qrun(QELASTIC, "monolithic").losses == qrun(ref, "monolithic").losses
    assert el.losses != qrun(ref, "per_worker").losses


@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_byte_contracts(engine):
    """ZO rounds book 4 bytes per live worker (4*M in the monolithic
    replay); FO rounds 4*d dense; the FO codec books nbytes x live workers
    per worker, nbytes in legacy mode; the QSGD baseline the same
    (tests/test_replay_fidelity.py)."""
    pw, mono = qrun(QELASTIC, "per_worker", engine=engine), qrun(QELASTIC, "monolithic",
                                                                   engine=engine)
    shrunk = [(i, k) for i, (k, o) in enumerate(zip(pw.active_counts, pw.orders))
              if k < H.M and o == 0]
    assert shrunk
    assert all(pw.comm_bytes[i] == 4 * k for i, k in shrunk)
    assert mono.comm_bytes[shrunk[0][0]] == 4 * H.M
    codec = C.qsgd(4)
    per, legacy = (qrun(QBASE, "per_worker", codec=codec, compress_mode=mode, engine=engine)
                   for mode in ("per_worker", "legacy"))
    assert {b for b, o in zip(per.comm_bytes, per.orders) if o == 1} == {
        codec.nbytes(48) * H.M}
    assert {b for b, o in zip(legacy.comm_bytes, legacy.orders) if o == 1} == {
        codec.nbytes(48)}
    assert all(b == 4 * H.M for b, o in zip(per.comm_bytes, per.orders) if o == 0)
    assert set(qrun(QBASE, "per_worker", "qsgd").comm_bytes) == {C.qsgd(8).nbytes(48) * H.M}
    assert set(qrun(QBASE, "per_worker", "qsgd", compress_mode="legacy").comm_bytes) == {
        C.qsgd(8).nbytes(48)}
    dense = qrun(QBASE, "per_worker", engine=engine)
    assert dense.comm_bytes == [4 * 48 if o == 1 else 4 * H.M for o in dense.orders]


def _snapshot(tree):
    return [x.clone() if isinstance(x, torch.Tensor) else x for x in tree_leaves(tree)]


@pytest.mark.parametrize("scenario,which,engine", [
    ("sync", "ho_sgd", "flat"), ("elastic", "ho_sgd", "flat"), ("stale2", "ho_sgd", "tree"),
    ("sync", "pa_sgd", "tree"), ("federated", "fed_ho_sgd", "flat")])
def test_steps_never_write_their_inputs(problem, scenario, which, engine):
    """The runner keeps references to parameters it has passed on (stale
    views, the monolithic pending step, checkpoints): every step, the fused
    flat round included, leaves the parameters, state and views it was
    handed unchanged bit for bit."""
    calls = []

    def guard(fn):
        def wrapped(t, params, state, batch, *a, **kw):
            held = [params, state, kw.get("views") or {}]
            before = [_snapshot(x) for x in held]
            out = fn(t, params, state, batch, *a, **kw)
            for b, x in zip(before, held):
                after = _snapshot(x)
                assert len(b) == len(after)
                for u, v in zip(b, after):
                    assert (torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v), t
            calls.append(t)
            return out
        return wrapped

    def hook(sm):
        sm.step = guard(sm.step)
        sm.executor.run = guard(sm.executor.run)

    res = H.run_port(problem, scenario, which, "per_worker", engine, sm_hook=hook)
    assert len(calls) >= H.N and len(res.steps) == H.N


def test_mesh_group_is_the_callers_or_a_transient_one(problem):
    """``make_sim_methods`` makes the HO family's 1x1 mesh under a world-size-1
    gloo group it destroys, or under the caller's group, which it keeps."""
    _, spec = H.cluster_pair("sync")
    params = params_from_numpy(problem[1], device="cpu")
    assert not dist.is_initialized()
    sm = S.make_sim_methods(mlp_loss, params, spec, which=["ho_sgd"])["ho_sgd"]
    assert not dist.is_initialized()
    from repro_torch.launch.mesh import process_group

    with process_group() as world:
        assert world == 1 and dist.is_initialized()
        S.make_sim_methods(mlp_loss, params, spec, which=["sync_sgd"])
        assert dist.is_initialized()
    assert not dist.is_initialized()
    # the steps hold no reference to the destroyed group
    res = S.simulate(sm, params, jbatches(problem[0], H.M * H.B, seed=1), spec, 2,
                     compute=S.compute_model_for(params, spec, H.B))
    assert res.orders == [1, 0] and all(np.isfinite(res.losses))
    assert tree_map(lambda x: x.device.type, res.params) == {k: "cpu" for k in params}
