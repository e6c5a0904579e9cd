"""The port's federated partial participation against ``repro.core.federated``.

On the CPU, both packages on the same inputs:

* the schedule: cohorts (with availability churn and its re-admitted
  survivor), client sizes and weights equal to the reference's for t in
  0..31 at availability 1.0 and 0.75 (numpy draws, copied: exact);
  ``cohort_shards`` gives the reference's rows and is keyed on the client's
  identity;
* the round-level pins of tests/test_federated.py: ``masked_average``'s
  closed form, lr=0 keeps the server value, a legacy wire is rejected,
  bytes per live client (codecs none and qsgd(8)) in ``comm_bytes`` and in a
  wrapped ``CommLedger`` equal to the reference's, 4 bytes per live client
  on a fed-HO ZO round;
* trajectories: 8 rounds of fed-HO-SGD (engines flat and pallas, N=64, K=4,
  availability 0.75, momentum 0.9) on the Fig. 2 MLP at hidden=16 against
  one reference run (its fused engine), losses to rtol 1e-4 and parameters to
  2% of the update (ROADMAP's parity rule with momentum: the coefficient
  (d/mu)(f1-f0) turns loss ulps into update noise); 8 rounds of FedAvg and
  FedDropoutAvg (the port handed the reference's ``jax.random.bernoulli``
  masks; full availability, so the reference compiles one cohort size) to
  rtol 1e-5 / atol 1e-6;
* client ids past 256: the engines' salts for a cohort of a 4096-client
  population equal the reference's bit for bit, and a fed-HO run over such
  cohorts tracks the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounds as JR
from repro.core.engine import make_engine as jmake_engine
from repro.core.federated import (
    ClientSampling as JSampling, cohort_shards as jcohort_shards,
    fed_avg_program as jfed_avg_program)
from repro.core.ho_sgd import HOSGDConfig as JCfg
from repro.data.synthetic import batches, make_classification
from repro.dist import CommLedger as JLedger
from repro.dist.compress import qsgd as jqsgd
from repro.models.mlp import init_mlp_classifier as jinit, mlp_loss as jmlp_loss
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core import federated as F
from repro_torch.core import rounds as R
from repro_torch.core.engine import make_engine
from repro_torch.core.ho_sgd import HOSGDConfig
from repro_torch.dist import CommLedger
from repro_torch.dist.collectives import _tree_nbytes
from repro_torch.dist.compress import qsgd
from repro_torch.models.mlp import mlp_loss

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

D_, K, N = 24, 4, 64
HIDDEN, B, ROUNDS, TAU, LR, MU = 16, 16, 8, 4, 0.05, 1e-3


def quad_loss(params, batch):
    return 0.5 * torch.mean(torch.sum((params["x"] - batch["t"]) ** 2, -1))


def jquad_loss(params, batch):
    return 0.5 * jnp.mean(jnp.sum((params["x"] - batch["t"]) ** 2, -1))


def problem(rows=4 * K):
    x = np.linspace(-1.0, 1.0, D_, dtype=np.float32)
    t = np.random.default_rng(0).normal(size=(rows, D_)).astype(np.float32)
    return {"x": torch.from_numpy(x.copy())}, {"t": t}, {"x": jnp.asarray(x)}, {"t": jnp.asarray(t)}


def spec(**kw):
    kw = dict(dict(n_clients=N, cohort_k=K, seed=0), **kw)
    return F.ClientSampling(**kw), JSampling(**kw)


def assert_update_close(got, want, start, what=""):
    """|got - want| <= 2% of the largest update of the leaf (+1e-7)."""
    got, want, start = (np.asarray(a, np.float32) for a in (got, want, start))
    scale = max(float(np.abs(want - start).max()), 1e-12)
    diff = float(np.abs(got - want).max())
    assert diff <= 0.02 * scale + 1e-7, (what, diff, scale)


# --------------------------------------------------------------------------- #
# the schedule
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("availability", [1.0, 0.75])
@pytest.mark.parametrize("seed", [0, 3])
def test_cohorts_sizes_and_weights_equal_reference(availability, seed):
    cs, jcs = spec(availability=availability, seed=seed)
    lens = set()
    for t in range(32):
        cohort = cs.cohort_for(t)
        assert cohort == jcs.cohort_for(t), t
        assert list(cohort) == sorted(set(cohort)) and all(0 <= i < N for i in cohort)
        np.testing.assert_array_equal(cs.client_weights(cohort), jcs.client_weights(cohort))
        assert cs.client_weights(cohort).dtype == np.float64
        lens.add(len(cohort))
    np.testing.assert_array_equal(cs.client_sizes(), jcs.client_sizes())
    assert lens == {K} if availability == 1.0 else max(lens) <= K and min(lens) >= 1


def test_all_down_round_readmits_the_reference_survivor():
    """At availability 0.05 most rounds lose every client and re-admit one
    seeded pick: the port picks the reference's."""
    cs, jcs = spec(availability=0.05, seed=1)
    readmitted = 0
    for t in range(64):
        assert cs.cohort_for(t) == jcs.cohort_for(t), t
        readmitted += len(cs.cohort_for(t)) == 1
    assert readmitted > 32


def test_sampling_spec_validation():
    for kw in (dict(n_clients=0, cohort_k=1), dict(n_clients=4, cohort_k=5),
               dict(n_clients=4, cohort_k=2, availability=0.0)):
        with pytest.raises(ValueError):
            F.ClientSampling(**kw)


def test_cohort_shards_rows_equal_reference_and_identity_keyed():
    cs, jcs = spec()
    tp, tb, _, jb = problem()
    for cohort, t in (([3, 9], 5), ([9, 50], 5), ([9], 6), ([0, 1, 2, 63], 0)):
        got = F.cohort_shards(tb, cohort, t, cs)["t"]
        np.testing.assert_array_equal(got, np.asarray(jcohort_shards(jb, cohort, t, jcs)["t"]))
    tensor = F.cohort_shards({"t": torch.from_numpy(tb["t"])}, [3, 9], 5, cs)["t"]
    a, b = F.cohort_shards(tb, [3, 9], 5, cs), F.cohort_shards(tb, [9, 50], 5, cs)
    np.testing.assert_array_equal(tensor.numpy(), a["t"])
    np.testing.assert_array_equal(a["t"][1], b["t"][0])          # client 9 either way
    assert not np.array_equal(b["t"][0], F.cohort_shards(tb, [9], 6, cs)["t"][0])
    assert a["t"].shape == (2, tb["t"].shape[0] // K, D_)


# --------------------------------------------------------------------------- #
# round-level pins (tests/test_federated.py)
# --------------------------------------------------------------------------- #
def test_masked_average_closed_form_with_float64_weights():
    stacked = {"a": torch.tensor([[2.0, 0.0, 0.0], [4.0, 4.0, 0.0]])}
    avg, wsum = R.masked_average(stacked, np.asarray([1.0, 3.0], np.float64))
    np.testing.assert_allclose(avg["a"].numpy(), [3.5, 4.0, 0.0])
    np.testing.assert_allclose(wsum["a"].numpy(), [4.0, 3.0, 0.0])
    # client sizes as float64 weights: the reference's float32 weighting
    cs, jcs = spec(availability=0.75, seed=3)
    x = np.random.default_rng(4).normal(size=(3, 7)).astype(np.float32)
    x[0, :3] = 0.0
    w = cs.client_weights([5, 17, 40])
    avg, wsum = R.masked_average({"v": torch.from_numpy(x)}, w)
    javg, jwsum = JR.masked_average({"v": jnp.asarray(x)}, jcs.client_weights([5, 17, 40]))
    np.testing.assert_allclose(avg["v"].numpy(), np.asarray(javg["v"]), rtol=1e-6)
    np.testing.assert_array_equal(wsum["v"].numpy(), np.asarray(jwsum["v"]))


def test_fed_avg_lr0_keeps_the_server_value():
    tp, tb, _, _ = problem()
    cs, _ = spec()
    prog = F.fed_avg_program(quad_loss, cs, lr=0.0, local_steps=2)
    p2, _, met = R.RoundExecutor(prog).run(0, tp, prog.init(tp), tb)
    np.testing.assert_allclose(p2["x"].numpy(), tp["x"].numpy(), rtol=1e-6)
    assert met["n_live"] == K and met["order"] == 1


def test_masked_average_round_rejects_legacy_wire_and_wrong_m():
    noop = lambda *a: None
    with pytest.raises(ValueError, match="per-client"):
        R.Round("f", 1, "masked_average", noop, noop, wire=R.Wire(qsgd(8), "legacy"))
    cs, _ = spec()
    with pytest.raises(ValueError, match="cohort_k"):
        R.ho_sgd_program(quad_loss, HOSGDConfig(tau=4, m=K + 1), client_sampling=cs)
    prog = F.fed_avg_program(quad_loss, cs, lr=0.1)
    assert prog.m == K and prog.client_sampling is cs
    tp, tb, _, _ = problem()
    with pytest.raises(ValueError, match="no stale views"):
        R.RoundExecutor(prog).run(0, tp, {}, tb, views={0: tp})


@pytest.mark.parametrize("codec", [None, "qsgd"])
def test_cohort_bytes_booked_per_live_client(codec):
    tp, tb, jp, jb = problem()
    cs, jcs = spec(availability=0.75, seed=3)
    wire = None if codec is None else R.Wire(qsgd(8))
    jwire = None if codec is None else JR.Wire(jqsgd(8))
    prog = F.fed_avg_program(quad_loss, cs, lr=0.05, local_steps=2, wire=wire)
    jprog = jfed_avg_program(jquad_loss, jcs, lr=0.05, local_steps=2, wire=jwire)
    ex, jex = R.RoundExecutor(prog), JR.RoundExecutor(jprog)
    led, jled = CommLedger(), JLedger()
    run = led.wrap("fed", lambda *a, **k: ex.run(*a, **k))
    jrun = jled.wrap("fed", lambda *a, **k: jex.run(*a, **k))
    st, jst = prog.init(tp), jprog.init(jp)
    per = _tree_nbytes(tp) if codec is None else qsgd(8).nbytes(D_)
    for t in range(4):
        live = len(cs.cohort_for(t))
        tp, st, met = run(t, tp, st, tb)
        jp, jst, jmet = jrun(t, jp, jst, jb)
        assert met["n_live"] == jmet["n_live"] == live
        assert met["comm_bytes"] == jmet["comm_bytes"] == per * live
        assert led.bytes_per_step("fed") == jled.bytes_per_step("fed") == per * live
        assert met["comm_bytes"] < per * N
    assert led.total_bytes() == jled.total_bytes()


def test_fed_ho_zo_round_books_4_bytes_per_live_client():
    tp, tb, jp, jb = problem()
    cs, jcs = spec(availability=0.75, seed=3)
    kw = dict(tau=4, mu=1e-3, m=K, lr=0.05, zo_lr=0.01, seed=0)
    prog = R.ho_sgd_program(quad_loss, HOSGDConfig(**kw), client_sampling=cs)
    jprog = JR.ho_sgd_program(jquad_loss, JCfg(**kw), client_sampling=jcs)
    ex, jex = R.RoundExecutor(prog), JR.RoundExecutor(jprog)
    st, jst = prog.init(tp), jprog.init(jp)
    led = CommLedger()
    zo = led.wrap("zo", lambda *a: ex.run(*a))
    for t in range(8):
        run = zo if t % 4 else ex.run
        tp, st, met = run(t, tp, st, tb)
        jp, jst, jmet = jex.run(t, jp, jst, jb)
        assert met["comm_bytes"] == jmet["comm_bytes"]
        assert met["n_live"] == len(cs.cohort_for(t))
        if met["order"] == 0:
            assert met["comm_bytes"] == 4 * met["n_live"]
            assert led.bytes_per_step("zo") == 4 * met["n_live"]
        else:
            assert met["comm_bytes"] == 4 * D_


# --------------------------------------------------------------------------- #
# trajectories on the Fig. 2 MLP
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mlp_setup():
    ds = make_classification("covtype")
    p0 = jinit(jax.random.key(0), ds.n_features, ds.n_classes, hidden=HIDDEN)
    data = [b for _, b in zip(range(ROUNDS), batches(ds, K * B, seed=1))]
    return p0, data, sum(int(x.size) for x in jax.tree.leaves(p0))


def run_both(prog, jprog, p0, data, rounds=ROUNDS):
    tp, jp = params_from_numpy(p0, device="cpu"), p0
    st, jst = prog.init(tp), jprog.init(jp)
    ex, jex = R.RoundExecutor(prog), JR.RoundExecutor(jprog)
    hist = []
    for t, b in zip(range(rounds), data):
        tp, st, met = ex.run(t, tp, st, b)
        jp, jst, jmet = jex.run(t, jp, jst, b)
        assert (met["order"], met["n_live"], met["comm_bytes"]) == \
            (jmet["order"], jmet["n_live"], jmet["comm_bytes"])
        hist.append((float(met["loss"]), float(jmet["loss"])))
    return tree_to_numpy(tp), jp, np.asarray(hist)


def fed_ho_programs(d, engine, **spec_kw):
    kw = dict(tau=TAU, mu=MU, m=K, lr=LR, zo_lr=LR * 30.0 / d, momentum=0.9)
    cs, jcs = spec(**spec_kw)
    return (R.ho_sgd_program(mlp_loss, HOSGDConfig(engine=engine, **kw), client_sampling=cs),
            JR.ho_sgd_program(jmlp_loss, JCfg(engine="fused", **kw), client_sampling=jcs))


@pytest.fixture(scope="module")
def fed_ho_reference(mlp_setup):
    """The reference's fed-HO run (its fused engine, the quickest to
    compile; its engines agree to ulps, tests/test_engine.py), shared by
    the port's engines."""
    p0, data, d = mlp_setup
    _, jprog = fed_ho_programs(d, "tree", availability=0.75, seed=2)
    jp, jst, jex, hist = p0, jprog.init(p0), JR.RoundExecutor(jprog), []
    for t, b in zip(range(ROUNDS), data):
        jp, jst, met = jex.run(t, jp, jst, b)
        hist.append((met["order"], met["n_live"], met["comm_bytes"], float(met["loss"])))
    return jp, hist


@pytest.mark.parametrize("engine", ["flat", "pallas"])
def test_fed_ho_sgd_trajectory_matches_reference(mlp_setup, fed_ho_reference, engine):
    p0, data, d = mlp_setup
    want, jhist = fed_ho_reference
    prog, _ = fed_ho_programs(d, engine, availability=0.75, seed=2)
    tp = params_from_numpy(p0, device="cpu")
    st, ex = prog.init(tp), R.RoundExecutor(prog)
    for t, b in zip(range(ROUNDS), data):
        tp, st, met = ex.run(t, tp, st, b)
        assert (met["order"], met["n_live"], met["comm_bytes"]) == jhist[t][:3]
        assert float(met["loss"]) == pytest.approx(jhist[t][3], rel=1e-4)
    assert {h[1] for h in jhist} != {K}               # churn happened
    got = tree_to_numpy(tp)
    for k in sorted(got):
        assert_update_close(got[k], want[k], p0[k], k)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_fed_avg_trajectory_matches_reference(mlp_setup, monkeypatch, dropout):
    """FedAvg, and FedDropoutAvg handed the reference's masks: the
    reference keys client w's leaves at round t with
    ``split(fold_in(fold_in(key(seed), t), w), n_leaves)``."""
    p0, data, _ = mlp_setup

    def jax_masks(seed, t, worker, leaves, keep):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), t), worker)
        return [torch.from_numpy(np.array(jax.random.bernoulli(k, keep, tuple(x.shape))))
                for k, x in zip(jax.random.split(key, len(leaves)), leaves)]

    calls = []
    monkeypatch.setattr(F, "dropout_masks", lambda *a: calls.append(a[:3]) or jax_masks(*a))
    cs, jcs = spec(seed=2)          # every cohort of K: one compiled reference local
    kw = dict(lr=LR, local_steps=2, dropout=dropout, seed=5)
    got, want, hist = run_both(F.fed_avg_program(mlp_loss, cs, **kw),
                               jfed_avg_program(jmlp_loss, jcs, **kw), p0, data)
    np.testing.assert_allclose(hist[:, 0], hist[:, 1], rtol=1e-5)
    for k in sorted(got):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert len(calls) == (sum(len(cs.cohort_for(t)) for t in range(ROUNDS)) if dropout else 0)


def test_dropout_masks_keyed_on_client_identity():
    leaves = [torch.zeros(50), torch.zeros(4, 5)]
    a = F.dropout_masks(5, 3, 812, leaves, 0.5)
    b = F.dropout_masks(5, 3, 812, leaves, 0.5)
    c = F.dropout_masks(5, 3, 37, leaves, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and a[1].shape == (4, 5) and a[0].dtype == torch.bool


# --------------------------------------------------------------------------- #
# client ids past 256: the salts are the reference's
# --------------------------------------------------------------------------- #
def test_client_ids_past_256_salts_bit_exact(mlp_setup):
    p0, _, _ = mlp_setup
    cs, _ = spec(n_clients=4096)
    ids = sorted({w for t in range(8) for w in cs.cohort_for(t)} | {256, 812, 70000})
    assert max(ids) >= 4096 > 256 and sum(w >= 256 for w in ids) > 8
    tp = params_from_numpy(p0, device="cpu")
    eng, jeng = make_engine("flat", tp, 7), jmake_engine("flat", p0, 7)
    for t in (1, 9):
        for w in ids:
            assert eng.salts(t, w) == [int(s) for s in jeng.salts(t, w)], (t, w)
        np.testing.assert_array_equal(
            eng.blk_salts_multi(t, ids).numpy(),
            np.asarray(jeng.blk_salts_multi(t, jnp.asarray(ids, jnp.uint32))))


def test_fed_ho_sgd_over_a_4096_client_population(mlp_setup):
    p0, data, d = mlp_setup
    prog, jprog = fed_ho_programs(d, "pallas", n_clients=4096, seed=1)
    assert all(max(prog.client_sampling.cohort_for(t)) >= 256 for t in range(4))
    got, want, hist = run_both(prog, jprog, p0, data, rounds=4)
    np.testing.assert_allclose(hist[:, 0], hist[:, 1], rtol=1e-4)
    for k in sorted(got):
        assert_update_close(got[k], want[k], p0[k], k)
