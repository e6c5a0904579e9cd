"""The port's simulator core (``repro_torch.sim.{costs,cluster,events}``)
against the reference's, on the CPU.

These modules are host arithmetic and numpy draws, copied, so every result
is held to the reference's bit for bit (``==`` on floats):

* every collective kind (flat, ring, tree, gossip) at w in {1, 2, 3, 4, 8}
  over one pod and two (the hierarchical reduce), the free functions, the
  exposed and overlapped times at buckets {1, 2, 8};
* ``ClusterSpec``'s seeded draws (slowdowns with jitter, stragglers and
  persistent speeds, failure gaps, downtimes) in their fixed order, the
  federated sampling schedule, and the specs each package refuses;
* the event core: ``EventLoop``'s FIFO tie-break, ``barrier_all_reduce``,
  ``async_all_reduce`` with and without ``LinkContention``, the planned
  async round and its commit, ``SharedLink`` and the contention routing,
  each compared span by span;
* the FLOP models: ``ComputeModel``, ``tree_fwd_flops`` on a torch tree
  against a JAX tree, ``config_fwd_flops`` on the port's ``ModelConfig``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as J
import repro_torch.sim as S
from repro.configs import get_config as jget_config
from repro_torch.configs import get_config

LINK = dict(alpha=3e-5, beta=1.0 / 7e8)
INTER = dict(alpha=1e-3, beta=1.0 / 1e8)
NBYTES = (0, 4, 16, 7_087_628, 123_457)


def models(kind, pods):
    """The same ``CollectiveModel`` in both packages."""
    out = []
    for mod in (J, S):
        inter = mod.LinkModel(**INTER) if pods > 1 else None
        out.append(mod.CollectiveModel(link=mod.LinkModel(**LINK), kind=kind, pods=pods,
                                       inter_link=inter))
    return out


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("kind", ["flat", "ring", "tree", "gossip"])
def test_collective_times_equal_reference(kind, pods):
    jm, tm = models(kind, pods)
    assert S.COLLECTIVE_KINDS == J.COLLECTIVE_KINDS
    for w in (1, 2, 3, 4, 8):
        for nb in NBYTES:
            assert tm.all_reduce_time(nb, w) == jm.all_reduce_time(nb, w)
            assert tm.time_components(nb, w) == jm.time_components(nb, w)
            for b in (1, 2, 8):
                for comp in (0.0, 1e-4, 0.37):
                    assert (S.exposed_comm_time(tm, nb, w, b, comp)
                            == J.exposed_comm_time(jm, nb, w, b, comp))
                    assert (S.overlapped_step_time(tm, nb, w, b, comp)
                            == J.overlapped_step_time(jm, nb, w, b, comp))
    assert jm.all_reduce_time(7_087_628, 4) > 0.0


@pytest.mark.parametrize("fn", ["ring_all_reduce_time", "tree_all_reduce_time",
                                "flat_all_reduce_time", "gossip_exchange_time"])
def test_free_collective_functions_equal_reference(fn):
    jl, tl = J.LinkModel(**LINK), S.LinkModel(**LINK)
    for w in (1, 2, 3, 4, 8):
        for nb in NBYTES:
            assert getattr(S, fn)(tl, nb, w) == getattr(J, fn)(jl, nb, w)
    assert tl.time(0) == jl.time(0) == 0.0 and tl.time(99) == jl.time(99)


def test_collective_model_refuses_what_the_reference_refuses():
    for mod in (J, S):
        with pytest.raises(AssertionError):
            mod.CollectiveModel(link=mod.LinkModel(**LINK), kind="mesh")
        with pytest.raises(AssertionError):
            mod.CollectiveModel(link=mod.LinkModel(**LINK), pods=2)


# --------------------------------------------------------------------------- #
# ClusterSpec: fields, derived models, draws
# --------------------------------------------------------------------------- #
SPECS = {
    "homogeneous": dict(),
    "jitter_stragglers": dict(jitter_sigma=0.2, straggler_prob=0.3, straggler_slowdown=5.0,
                              seed=7),
    "hetero": dict(rel_speeds=(1.0, 0.5, 1.0, 0.25), jitter_sigma=0.1, seed=3),
    "failures": dict(fail_rate=500.0, ckpt_every=2, restart_time=1e-3, seed=11),
    "elastic": dict(elastic=True, fail_rate=5000.0, downtime=5e-5, restart_time=1e-5,
                    jitter_sigma=0.1, seed=5),
    "two_pods_ring": dict(collective="ring", seed=2),
    "federated": dict(n_clients=64, cohort_k=4, availability=0.75, seed=9),
}


def specs(name):
    kw = dict(SPECS[name])
    topo = {}
    if name == "two_pods_ring":
        topo = {"J": dict(topology=J.Topology(pods=2, inter_bandwidth=2.5e5)),
                "S": dict(topology=S.Topology(pods=2, inter_bandwidth=2.5e5))}
    return (J.ClusterSpec(m=4, bandwidth=1e6, **kw, **topo.get("J", {})),
            S.ClusterSpec(m=4, bandwidth=1e6, **kw, **topo.get("S", {})))


@pytest.mark.parametrize("name", list(SPECS))
def test_cluster_spec_draws_equal_reference(name):
    js, ts = specs(name)
    assert dataclasses.asdict(ts).keys() == dataclasses.asdict(js).keys()
    assert ts.speeds() == js.speeds()
    assert (ts.link.alpha, ts.link.beta) == (js.link.alpha, js.link.beta)
    for nb in (16, 7_087_628):
        for w in (None, 1, 3, 4):
            assert ts.collective_time(nb, w) == js.collective_time(nb, w)
    jr, tr = js.rng(), ts.rng()
    for _ in range(25):
        # the runner's draw order: slowdowns every iteration, a failure gap
        # and a downtime as events require; the streams stay in lockstep
        np.testing.assert_array_equal(ts.draw_slowdowns(tr), js.draw_slowdowns(jr))
        assert ts.draw_failure_gap(tr) == js.draw_failure_gap(jr)
        assert ts.draw_downtime(tr) == js.draw_downtime(jr)
        assert int(tr.integers(4)) == int(jr.integers(4))
    if name == "federated":
        for t in range(40):
            assert ts.sampling.cohort_for(t) == js.sampling.cohort_for(t)
        np.testing.assert_array_equal(ts.sampling.client_sizes(), js.sampling.client_sizes())
    else:
        assert ts.sampling is None and js.sampling is None


def test_bandwidth_constrained_equals_reference():
    for kw in ({}, dict(m=8, seed=4, collective="tree", max_staleness=2)):
        assert (dataclasses.asdict(S.bandwidth_constrained(**kw))
                == dataclasses.asdict(J.bandwidth_constrained(**kw)))
    assert (S.Topology(pods=4).workers_per_pod(6) == J.Topology(pods=4).workers_per_pod(6)
            == 2)


@pytest.mark.parametrize("kw", [
    dict(m=0), dict(bandwidth=0.0), dict(collective="mesh"), dict(max_staleness=-1),
    dict(rel_speeds=(1.0, 1.0)), dict(elastic=True, m=1), dict(fail_rate=1.0),
    dict(availability=0.0), dict(n_clients=8, cohort_k=3), dict(cohort_k=4),
    dict(n_clients=8, cohort_k=4, max_staleness=1), dict(downtime=0.0),
])
def test_cluster_spec_refuses_what_the_reference_refuses(kw):
    for mod in (J, S):
        with pytest.raises(AssertionError):
            mod.ClusterSpec(**{"m": 4, **kw})


# --------------------------------------------------------------------------- #
# the event core
# --------------------------------------------------------------------------- #
def spans(loop):
    return [dataclasses.astuple(s) for s in loop.spans]


def test_event_loop_fifo_tiebreak_equals_reference():
    loops = []
    for mod in (J, S):
        loop = mod.EventLoop()
        for w in (3, 1, 2):
            loop.schedule(1.0, "compute", w)
        loop.schedule(0.5, "compute", 9)
        loop.schedule(1.0, "fail", 0)
        popped = [loop.pop().worker for _ in range(5)]
        loop.record(2.0, "restore", 4, t0=1.0)
        loop.annotate("barrier", 1.0, 1.5, worker=2, name="barrier.wait")
        loop.annotate("barrier", 1.5, 1.5, worker=2)          # empty: dropped
        loops.append((popped, loop.now, loop.trace, spans(loop), loop.pending))
    assert loops[1] == loops[0]
    assert loops[1][0] == [9, 3, 1, 2, 0]


@pytest.mark.parametrize("active", [None, [0, 2, 3]])
@pytest.mark.parametrize("comm", [0.0, 1.5])
def test_barrier_all_reduce_equals_reference(active, comm):
    out = []
    for mod in (J, S):
        loop, clocks = mod.EventLoop(), mod.WorkerClocks.start(4, at=1.0)
        clocks.t[2] = 1.25
        done = mod.barrier_all_reduce(loop, clocks, [0.1, 0.7, 0.3, 0.2], comm,
                                      active=active, nbytes=64)
        done2 = mod.barrier_all_reduce(loop, clocks, [0.2, 0.1, 0.1, 0.4], comm / 3,
                                       kind="exchange", active=active)
        out.append((done, done2, clocks.t, loop.trace, spans(loop)))
    assert out[1] == out[0]
    assert [k for _, k, _ in out[1][3]][-1] == ("exchange" if comm else "barrier")


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("contended", [False, True])
def test_async_rounds_equal_reference(pods, contended):
    """Three unbarriered rounds gated on the commit one round back, the
    exchanges serialized on the shared links when ``contended``, then a
    planned round committed by hand with its annotations."""
    out = []
    for mod in (J, S):
        loop, clocks = mod.EventLoop(), mod.WorkerClocks.start(4)
        lc = mod.LinkContention(4, pods) if contended else None
        commits = []
        for r, dts in enumerate(([0.1, 0.4, 0.2, 0.3], [0.2, 0.2, 0.5, 0.1],
                                 [0.3, 0.1, 0.1, 0.1])):
            gate = commits[r - 2] if r >= 2 else 0.0
            commits.append(mod.async_all_reduce(loop, clocks, dts, 0.05, gate,
                                                active=[0, 1, 3] if r == 1 else None,
                                                contention=lc))
        entries, trial = mod.events.plan_async_round(
            clocks, [0.1, 0.2, 0.3, 0.4], commits[-1], [0, 1, 2, 3],
            lambda i: (0.02 * (i + 1), 0.01 if pods > 1 else 0.0), lc)
        done = mod.events.commit_async_round(loop, clocks, entries, nbytes=16)
        state = None if lc is None else (
            [l.free_at for l in lc.pod_links], lc.inter.free_at,
            [l.free_at for l in trial.pod_links], trial.inter.free_at)
        out.append((commits, done, clocks.t, loop.trace, spans(loop),
                    [tuple(e) for e in entries], state))
    assert out[1] == out[0]


def test_shared_link_and_contention_routing_equal_reference():
    out = []
    for mod in (J, S):
        link = mod.SharedLink()
        ends = [link.acquire(10.0, 0.25), link.acquire(10.0, 0.25),
                link.acquire(15.0, 0.25), link.acquire(0.0, 0.0)]
        lc = mod.LinkContention(m=6, pods=4)
        pods = [lc.pod_of(w) for w in range(6)]
        routed = [lc.transfer(w, 0.1 * w, intra_s=1.0, inter_s=0.5 * (w % 2))
                  for w in (0, 1, 2, 3, 5, 4)]
        trial = lc.clone()
        trial.transfer(0, 10.0, intra_s=1.0)
        before = lc.pod_links[0].free_at
        lc.adopt(trial)
        out.append((ends, link.free_at, pods, routed, before, lc.pod_links[0].free_at,
                    lc.inter.free_at))
    assert out[1] == out[0]
    assert out[1][0][:2] == [10.25, 10.5]


def test_worker_clocks_equal_reference():
    out = []
    for mod in (J, S):
        c = mod.WorkerClocks.start(3, at=0.5)
        c.advance(1, 2.0)
        c.advance(2, 0.75)
        a = c.barrier([0, 2])
        snap = list(c.t)
        b = c.barrier()
        c.set_all(9.0, [1])
        out.append((a, snap, b, c.t, c.m))
    assert out[1] == out[0]


# --------------------------------------------------------------------------- #
# the FLOP models
# --------------------------------------------------------------------------- #
def test_compute_model_and_flop_estimates_equal_reference():
    jc, tc = (mod.ComputeModel(fwd_flops=2.5e6, flops_per_sec=1e9, fwd_bwd_ratio=3.0)
              for mod in (J, S))
    for fe, ge, speed in ((2.0, 0.0, 1.0), (0.0, 1.0, 0.25), (1.25, 2.0, 3.0)):
        assert tc.flops(fe, ge) == jc.flops(fe, ge)
        assert tc.time(fe, ge, speed) == jc.time(fe, ge, speed)
    shapes = {"b1": (13,), "w1": (54, 13), "w2": (13, 7)}
    jt = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    tt = {k: torch.zeros(s, dtype=torch.bfloat16 if k == "w2" else torch.float32)
          for k, s in shapes.items()}
    assert S.tree_fwd_flops(tt, 64) == J.tree_fwd_flops(jt, 64) == 2.0 * 806 * 64
    for arch in ("gemma2-2b", "qwen3-14b"):
        assert (S.config_fwd_flops(get_config(arch), 2, 128)
                == J.config_fwd_flops(jget_config(arch), 2, 128))
    js, ts = specs("homogeneous")
    assert (S.compute_model_for(tt, ts, 16) == S.ComputeModel(
        fwd_flops=J.compute_model_for(jt, js, 16).fwd_flops, flops_per_sec=1e12))
    assert S.compute_model_for(tt, ts, 16, fwd_flops=7.0).fwd_flops == 7.0


def test_step_cost_and_method_cross_check():
    """``validate_against_method`` holds the runner's per-order eval counts to
    the port's own ``Method`` hooks, as it does the reference's."""
    from repro_torch.core import HOSGDConfig, make_ho_sgd
    from repro_torch.sim.costs import StepCost, validate_against_method

    tau = 4
    meth = make_ho_sgd(lambda p, b: p["x"].sum(), HOSGDConfig(tau=tau, m=4, lr=0.1))
    costs = {1: StepCost(0.0, 1.0, 0), 0: StepCost(2.0, 0.0, 0)}
    validate_against_method(meth, 64, costs, {1: 1.0 / tau, 0: (tau - 1.0) / tau})
    with pytest.raises(AssertionError, match="fevals drift"):
        validate_against_method(meth, 64, {1: costs[1], 0: StepCost(3.0, 0.0, 0)},
                                {1: 1.0 / tau, 0: (tau - 1.0) / tau})
