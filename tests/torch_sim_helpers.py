"""Shared set-up of the simulator parity tests (``tests/test_torch_sim*.py``).

Both packages replay the same method on the same ``ClusterSpec``, data and
initial parameters (the reference's, built in JAX and handed over with
``convert.params_from_numpy``): the §5.2 MLP at hidden 12 on the covtype
stand-in (d = 907), m = 4, B = 8 per worker, tau = 4, 16 iterations, the
test-set loss evaluated every 4 iterations against a target no run reaches
(so an early stop never falls on different iterations).

* Scenarios: synchronous; stragglers with jitter; persistent heterogeneous
  speeds; failures with checkpoint rollback; elastic membership;
  ``max_staleness`` 2; two pods with a ring collective; overlap buckets 2;
  federated 64:4 with availability 0.75.  Every method of
  ``make_sim_methods``, both replay modes where the scenario allows both, and
  the port's engines ``tree`` and ``flat`` against the reference's ``fused``
  and ``flat``.  The cases are split over five test files (``CASES``) by
  scenario, so that each file runs in about a minute here: the reference
  traces its ZO step anew for every case (~4 s).
* Exact: ``trace``, ``steps``, ``times``, ``orders``, ``comm_bytes``,
  ``active_counts``, ``failures``, ``rejoins``, the evaluations' times and
  ``summary()`` but its loss.  Losses (training and evaluation) to rtol 1e-4,
  the step-level rule.  Final parameters: first-order-only runs to rtol 1e-6 /
  atol 1e-7, runs with ZO rounds to 2% of the update (ROADMAP "Parity
  tolerances": the coefficient (d/mu)(f1-f0) turns loss ulps into update
  noise).
* Draws: RI-SGD's indices, the QSGD codec's uniforms and FedDropoutAvg's
  masks are ``jax.random`` draws in the reference; the port is handed them by
  monkeypatching ``core.baselines.ri_indices``, ``dist.compress.uniform`` and
  ``core.federated.dropout_masks`` (tests/test_torch_baselines.py,
  tests/test_torch_federated.py).
* On this jax the reference's one-device ZO step lowers through
  ``shard_map``, which evaluates worker 0 only and books 4 bytes;
  ``reference_auto_branch`` switches ``repro.compat.HAS_PARTIAL_AUTO_COLLECTIVES``
  off, so the reference runs its auto-sharded branch, the formulation the
  port mirrors (tests/test_torch_distributed.py).

Imported by the test files as a top-level module, as ``torch_dist_helpers``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as J
import repro_torch.sim as S
from repro import compat
from repro.data.synthetic import batches as jbatches
from repro.data.synthetic import make_classification
from repro.dist.compress import get_compressor as jget_compressor
from repro.models.mlp import init_mlp_classifier as jinit_mlp
from repro.models.mlp import mlp_loss as jmlp_loss
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core import baselines as TB
from repro_torch.core import directions as D
from repro_torch.core import federated as TF
from repro_torch.dist import compress as C
from repro_torch.models.mlp import mlp_loss

M, B, TAU, N, HIDDEN = 4, 8, 4, 16, 12
LR, MU, SEED = 0.05, 1e-3, 0
TARGET = 0.05                        # far below every loss a 16-iteration run reaches
EVAL_EVERY = 4
FO_ONLY = {"sync_sgd", "pa_sgd", "pa_gossip", "ri_sgd", "qsgd", "fed_avg", "fed_dropout_avg"}

BASE = dict(m=M, flops_per_sec=1e9, alpha=1e-5, bandwidth=1e6, seed=0)
SCENARIOS = {
    "sync": {},
    "stragglers": dict(straggler_prob=0.3, straggler_slowdown=5.0, jitter_sigma=0.2, seed=7),
    "hetero": dict(rel_speeds=(1.0, 1.0, 1.0, 0.25)),
    "failure": dict(fail_rate=250.0, ckpt_every=2, restart_time=1e-3, seed=3),
    "elastic": dict(elastic=True, fail_rate=300.0, downtime=2e-3, restart_time=1e-5,
                    jitter_sigma=0.1, seed=3),
    "stale2": dict(rel_speeds=(1.0, 1.0, 1.0, 0.25), max_staleness=2),
    "two_pods_ring": dict(collective="ring", seed=2),
    "overlap2": {},
    "federated": dict(n_clients=64, cohort_k=4, availability=0.75, seed=9),
}
ENGINE_REF = {"tree": "fused", "flat": "flat"}

#: (scenario, method, replay, port engine[, codec, compress mode]) per test file
CASES = {
    "test_torch_sim": [
        ("sync", "ho_sgd", "per_worker", "tree"), ("sync", "ho_sgd", "monolithic", "tree"),
        ("sync", "ho_sgd", "per_worker", "flat"),
        ("stragglers", "ho_sgd", "per_worker", "tree"),
        ("stragglers", "ho_sgd", "monolithic", "flat"),
        ("hetero", "ho_sgd", "per_worker", "tree"), ("hetero", "ho_sgd", "monolithic", "tree")],
    "test_torch_sim_faults": [
        ("failure", "ho_sgd", "per_worker", "tree"), ("failure", "ho_sgd", "monolithic", "tree"),
        ("failure", "pa_sgd", "per_worker", "tree"),
        ("elastic", "ho_sgd", "per_worker", "tree"), ("elastic", "ho_sgd", "per_worker", "flat"),
        ("elastic", "ho_sgd", "monolithic", "tree"), ("elastic", "qsgd", "per_worker", "tree")],
    "test_torch_sim_async": [
        ("stale2", "ho_sgd", "per_worker", "tree"), ("stale2", "ho_sgd", "per_worker", "flat"),
        ("stale2", "ho_sgd", "monolithic", "tree"),
        ("two_pods_ring", "ho_sgd", "per_worker", "tree"),
        ("two_pods_ring", "ho_sgd", "monolithic", "tree"),
        ("two_pods_ring", "pa_gossip", "per_worker", "tree"),
        ("overlap2", "ho_sgd", "per_worker", "flat"), ("overlap2", "ho_sgd", "monolithic", "tree")],
    "test_torch_sim_methods": [
        ("sync", w, "per_worker", "tree") for w in (
            "ho_sgd_adaptive", "sync_sgd", "zo_sgd", "pa_sgd", "pa_gossip", "ri_sgd", "qsgd")
    ] + [("sync", "zo_sgd", "per_worker", "flat"),
         ("sync", "ho_sgd", "per_worker", "tree", "qsgd", "per_worker"),
         ("sync", "sync_sgd", "per_worker", "tree", "qsgd", "legacy"),
         ("sync", "qsgd", "monolithic", "tree")],
    "test_torch_sim_federated": [
        ("federated", "fed_ho_sgd", "per_worker", "tree"),
        ("federated", "fed_ho_sgd", "per_worker", "flat"),
        ("federated", "fed_avg", "per_worker", "tree"),
        ("federated", "fed_dropout_avg", "per_worker", "tree")],
}


def case_id(c):
    return "-".join(c)


def reference_auto_branch(monkeypatch):
    """The reference's ZO step on its auto-sharded branch (module docstring):
    each test file applies it to every test through an autouse fixture."""
    monkeypatch.setattr(compat, "HAS_PARTIAL_AUTO_COLLECTIVES", False)


def make_problem():
    """The covtype stand-in and the reference's initial MLP parameters (numpy)."""
    ds = make_classification("covtype", n_train=1024, n_test=256, seed=0)
    jp = jinit_mlp(jax.random.key(0), ds.n_features, ds.n_classes, hidden=HIDDEN)
    return ds, jax.tree.map(np.asarray, jp)


def cluster_pair(name):
    kw = {**BASE, **SCENARIOS[name]}
    if name == "two_pods_ring":
        return (J.ClusterSpec(topology=J.Topology(pods=2, inter_bandwidth=2.5e5), **kw),
                S.ClusterSpec(topology=S.Topology(pods=2, inter_bandwidth=2.5e5), **kw))
    return J.ClusterSpec(**kw), S.ClusterSpec(**kw)


def hand_over_draws(monkeypatch, n_leaves, mode, steps=64):
    """The reference's RI indices, QSGD uniforms (of the codec ``mode``) and
    FedDropoutAvg masks, keyed as the port keys them (module docstring).
    Each kind of draw has its own map: the port's keys of two kinds may
    coincide (``fold(0, 0) == 0``)."""
    ri, uni = {}, {}

    def put(keys, port_key, jax_key):
        assert keys.setdefault(port_key, jax_key) is jax_key, "port keys collide"

    for t in range(steps):
        put(ri, D.fold(t, t), jax.random.fold_in(jax.random.key(t), t))
        kt = jax.random.fold_in(jax.random.key(SEED), t)
        for i in range(n_leaves):
            if mode == "legacy":
                put(uni, D.fold(D.fold(SEED, t), i), jax.random.fold_in(kt, i))
            for w in range(M if mode == "per_worker" else 0):
                put(uni, D.fold(D.fold(D.fold(SEED, t), w), i),
                    jax.random.fold_in(jax.random.fold_in(kt, w), i))

    monkeypatch.setattr(TB, "ri_indices", lambda key, m, n_red, high: torch.from_numpy(
        np.array(jax.random.randint(ri[key], (m, n_red), 0, high), np.int64)))
    monkeypatch.setattr(C, "uniform", lambda key, shape, device: torch.from_numpy(
        np.array(jax.random.uniform(uni[key], tuple(shape)))))

    def jax_masks(seed, t, worker, leaves, keep):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), t), worker)
        return [torch.from_numpy(np.array(jax.random.bernoulli(k, keep, tuple(x.shape))))
                for k, x in zip(jax.random.split(key, len(leaves)), leaves)]

    monkeypatch.setattr(TF, "dropout_masks", jax_masks)


def sim_kw(scenario, which, mode):
    """``make_sim_methods``'s arguments, the same in both packages."""
    return dict(tau=TAU, lr=LR, mu=MU, seed=SEED, which=[which], compress_mode=mode,
                overlap_buckets=2 if scenario == "overlap2" else 1, local_steps=2)


def run_ref(problem, scenario, which, replay, engine, codec=None, mode="per_worker"):
    ds, p0 = problem
    spec, _ = cluster_pair(scenario)
    params = jax.tree.map(jnp.asarray, p0)
    sm = J.make_sim_methods(jmlp_loss, params, spec, engine=ENGINE_REF[engine],
                            codec=jget_compressor(codec),
                            **sim_kw(scenario, which, mode))[which]
    ev = {"x": jnp.asarray(ds.x_test), "y": jnp.asarray(ds.y_test)}
    return J.simulate(sm, params, jbatches(ds, M * B, seed=1), spec, N,
                      compute=J.compute_model_for(params, spec, B),
                      eval_fn=jax.jit(lambda p: jmlp_loss(p, ev)), eval_every=EVAL_EVERY,
                      target_loss=TARGET, replay=replay)


def run_port(problem, scenario, which, replay, engine, codec=None, mode="per_worker",
             sm_hook=None):
    ds, p0 = problem
    _, spec = cluster_pair(scenario)
    params = params_from_numpy(p0, device="cpu")
    sm = S.make_sim_methods(mlp_loss, params, spec, engine=engine,
                            codec=C.get_compressor(codec),
                            **sim_kw(scenario, which, mode))[which]
    if sm_hook is not None:
        sm_hook(sm)
    ev = {"x": torch.from_numpy(ds.x_test), "y": torch.from_numpy(ds.y_test)}
    return S.simulate(sm, params, jbatches(ds, M * B, seed=1), spec, N,
                      compute=S.compute_model_for(params, spec, B),
                      eval_fn=torch.no_grad()(lambda p: mlp_loss(p, ev)),
                      eval_every=EVAL_EVERY, target_loss=TARGET, replay=replay)


def assert_update_close(got, want, start, what=""):
    """|got - want| <= 2% of the largest update (+1e-7)."""
    scale = max(float(np.abs(want - start).max()), 1e-12)
    diff = float(np.abs(got - want).max())
    assert diff <= 0.02 * scale + 1e-7, (what, diff, scale)



def check_against_reference(problem, monkeypatch, case):
    """Run ``case`` in both packages and hold the port to the reference by
    the rules of the module docstring."""
    scenario, which, replay, engine, *codec = case
    hand_over_draws(monkeypatch, len(problem[1]), codec[1] if codec else "per_worker")
    want = run_ref(problem, scenario, which, replay, engine, *codec)
    got = run_port(problem, scenario, which, replay, engine, *codec)
    assert got.trace == want.trace
    assert got.steps == want.steps and got.times == want.times
    assert got.orders == want.orders and got.comm_bytes == want.comm_bytes
    assert got.active_counts == want.active_counts
    assert (got.failures, got.rejoins) == (want.failures, want.rejoins)
    assert [e[0] for e in got.evals] == [e[0] for e in want.evals]
    assert [e[2] for e in got.evals] == [e[2] for e in want.evals]
    gs, ws = got.summary(), want.summary()
    assert gs.pop("final_loss") == pytest.approx(ws.pop("final_loss"), rel=1e-4)
    assert gs == ws
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    np.testing.assert_allclose([e[1] for e in got.evals], [e[1] for e in want.evals],
                               rtol=1e-4)
    assert min(want.losses) > 2 * TARGET and got.time_to_loss(TARGET) == np.inf
    # the scenario did what it is for
    kinds = {k for _, k, _ in want.trace}
    assert {"failure": want.failures > 0, "elastic": want.rejoins > 0,
            "stale2": "async_exchange" in kinds,
            "federated": min(want.active_counts) < M}.get(scenario, True)
    assert got.steps[-1] == N - 1          # every iteration committed
    p0, mine, theirs = problem[1], tree_to_numpy(got.params), jax.tree.map(np.asarray,
                                                                           want.params)
    for k in sorted(p0):
        if which in FO_ONLY:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert_update_close(mine[k], theirs[k], p0[k], k)
