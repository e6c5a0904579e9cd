"""The port's round IR, comm ledger and codecs against the JAX package.

Follows tests/test_rounds_equivalence.py and tests/test_comm_ledger.py on the
same quadratic problem (D=96, m=4):

* schedule: ``round_for`` gives the reference's orders, ``t_step`` and
  ``since_fo`` (fixed, adaptive and ZO-only);
* executor against the reference executor: FO rounds to the reference's
  own tolerances (rtol 1e-6 / atol 1e-7); ZO rounds to 2% of the update
  (the reference's vmapped coefficients drift from its own unrolled ones --
  the two reference cases are red at jax 0.9 -- and the coefficient
  (d/mu)(f1-f0) turns loss ulps into update noise, as in
  test_torch_ho_sgd.py); within the port the executor is held bitwise to
  ``make_ho_sgd`` on ZO rounds (the same per-worker calls);
* collectives: ``neighbor_mix``, gossip, ``masked_average``, the wire
  modes and the codec matrix in closed form; ``comm_bytes`` and ledger
  totals equal to the reference's as integers;
* codecs: QSGD given the reference's uniforms decodes to the reference's
  values; signSGD and top-k in closed form;
* an import check that the new modules pull in neither jax nor repro.
"""
import gc
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounds as JR
from repro.core.ho_sgd import HOSGDConfig as JCfg
from repro.dist import CommLedger as JLedger
from repro.dist import collectives as jcoll
from repro.dist import compress as JC
from repro.metrics.logging import comm_report as jcomm_report
from repro_torch.core import directions as D
from repro_torch.core import rounds as R
from repro_torch.core.engine import make_engine
from repro_torch.core.ho_sgd import HOSGDConfig, make_ho_sgd
from repro_torch.dist import CommLedger, collectives as coll
from repro_torch.dist import compress as C
from repro_torch.metrics import comm_report
from repro_torch.opt.optimizers import apply_deltas, const_schedule, sgd

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

DIM, M = 96, 4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def quad_loss(params, batch):
    return 0.5 * torch.mean(torch.sum((params["x"] - batch["t"]) ** 2, -1))


def jquad_loss(params, batch):
    return 0.5 * jnp.mean(jnp.sum((params["x"] - batch["t"]) ** 2, -1))


def problem():
    x = np.linspace(-1.0, 1.0, DIM, dtype=np.float32)
    t = np.random.default_rng(0).normal(size=(2 * M, DIM)).astype(np.float32)
    return ({"x": torch.from_numpy(x.copy())}, {"t": t},
            {"x": jnp.asarray(x)}, {"t": jnp.asarray(t)})


def cfg_kw(**kw):
    return dict(dict(tau=4, mu=1e-3, m=M, lr=0.1, zo_lr=0.05), **kw)


def assert_update_close(got, want, start, what=""):
    """|got - want| <= 2% of the largest update (+1e-7)."""
    got, want, start = (np.asarray(a, np.float32) for a in (got, want, start))
    scale = max(float(np.abs(want - start).max()), 1e-12)
    diff = float(np.abs(got - want).max())
    assert diff <= 0.02 * scale + 1e-7, (what, diff, scale)


# --------------------------------------------------------------------------- #
# schedule
# --------------------------------------------------------------------------- #
def test_ho_program_schedule_matches_reference():
    sched = lambda t: 2 + t // 3
    for kw in (dict(tau_schedule=sched), dict(), dict(zo_only=True)):
        prog = R.ho_sgd_program(quad_loss, HOSGDConfig(**cfg_kw()), **kw)
        jprog = JR.ho_sgd_program(jquad_loss, JCfg(**cfg_kw()), **kw)
        since = jsince = 0
        for t in range(12):
            rs = prog.round_for(t, {"since_fo": since})
            js = jprog.round_for(t, {"since_fo": jsince})
            assert (rs.round.order, rs.t_step, rs.host_updates) == \
                (js.round.order, js.t_step, js.host_updates)
            since = jsince = js.host_updates["since_fo"]
    assert prog.comm_scalars(1000) == jprog.comm_scalars(1000)


# --------------------------------------------------------------------------- #
# executor
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", ["tree", "pallas"])
def test_executor_matches_reference_executor(engine):
    tp, tb, jp, jb = problem()
    prog = R.ho_sgd_program(quad_loss, HOSGDConfig(**cfg_kw(engine=engine)))
    jprog = JR.ho_sgd_program(jquad_loss, JCfg(**cfg_kw(engine="tree")))
    ex, jex = R.RoundExecutor(prog), JR.RoundExecutor(jprog)
    st, jps, jst = prog.init(tp), jp, jprog.init(jp)
    for t in range(6):
        # each round from the reference's params, so drift does not compound
        ps = {"x": torch.from_numpy(np.asarray(jps["x"]).copy())}
        ps, st, me = ex.run(t, ps, st, tb)
        jps2, jst, mj = jex.run(t, jps, jst, jb)
        assert me["order"] == mj["order"] and me["comm_bytes"] == mj["comm_bytes"]
        assert me["comm_bytes"] == (4 * DIM if t % 4 == 0 else 4 * M)
        assert float(me["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
        if me["order"] == 1:
            np.testing.assert_allclose(ps["x"].numpy(), np.asarray(jps2["x"]),
                                       rtol=1e-6, atol=1e-7)
        else:
            assert_update_close(ps["x"].numpy(), jps2["x"], np.asarray(jps["x"]), t)
        jps = jps2


@pytest.mark.parametrize("engine", ["tree", "fused", "pallas"])
def test_executor_zo_rounds_bitwise_equal_make_ho_sgd(engine):
    """The executor calls the same per-worker coefficient evaluations and
    the same reconstruction as make_ho_sgd's ZO step: a whole ZO-only run is
    bitwise equal, and so is every ZO round of HO-SGD from the same state
    (its FO rounds average per-worker gradients instead of taking the
    gradient of the mean: equal to rtol 1e-6).  The flat engine is left out:
    make_ho_sgd runs its fused step path, whose sum of squares is taken in
    another order."""
    tp, tb, _, _ = problem()
    kw = cfg_kw(engine=engine)
    prog = R.ho_sgd_program(quad_loss, HOSGDConfig(**kw), zo_only=True)
    zo_ref = make_ho_sgd(quad_loss, HOSGDConfig(**dict(kw, tau=1 << 30)))
    ex = R.RoundExecutor(prog)
    ps, st, pr, sr = tp, prog.init(tp), tp, zo_ref.init(tp)
    for t in range(1, 6):
        ps, st, me = ex.run(t, ps, st, tb)
        pr, sr, mr = zo_ref.step(t, pr, sr, tb)
        assert torch.equal(ps["x"], pr["x"]) and torch.equal(me["loss"], mr["loss"])
    prog = R.ho_sgd_program(quad_loss, HOSGDConfig(**kw))
    ref = make_ho_sgd(quad_loss, HOSGDConfig(**kw))
    meth = R.to_method(prog)
    st, sr = prog.init(tp), ref.init(tp)
    for t in range(6):
        ps, st, me = meth.step(t, tp, st, tb)
        pr, sr, mr = ref.step(t, tp, sr, tb)
        assert me["order"] == mr["order"]
        if me["order"] == 0:
            assert torch.equal(ps["x"], pr["x"])
        else:
            np.testing.assert_allclose(ps["x"].numpy(), pr["x"].numpy(), rtol=1e-6, atol=1e-7)
        tp = pr


def test_executor_zo_subset_uses_only_live_workers():
    tp, tb, jp, jb = problem()
    ho = HOSGDConfig(**cfg_kw())
    opt = sgd(const_schedule(ho.lr))
    prog = R.ho_sgd_program(quad_loss, ho, opt)
    ex = R.RoundExecutor(prog)
    t, live = 1, [0, 2]
    ps, _, met = ex.run(t, tp, prog.init(tp), tb, workers=live)
    assert met["order"] == 0 and met["comm_bytes"] == 4 * len(live) and met["n_live"] == 2
    # by hand: the live workers' coefficients, reconstructed over them
    eng = make_engine(ho.engine, tp, ho.seed)
    shards = R.split_shards({"t": torch.from_numpy(tb["t"])}, M)
    cs = torch.stack([eng.zo_coeff(quad_loss, tp, {"t": shards["t"][w]}, t, w, ho.mu)[0]
                      for w in live])
    rec = eng.reconstruct(cs, t, live)
    deltas, _ = opt.update({"x": rec["x"] * (ho.zo_scale / len(live))}, (), tp, t)
    assert torch.equal(ps["x"], apply_deltas(tp, deltas)["x"])
    # against the reference executor, and unlike the full round
    jprog = JR.ho_sgd_program(jquad_loss, JCfg(**cfg_kw()))
    jps, _, jmet = JR.RoundExecutor(jprog).run(t, jp, jprog.init(jp), jb, workers=live)
    assert jmet["comm_bytes"] == met["comm_bytes"]
    assert_update_close(ps["x"].numpy(), jps["x"], np.asarray(jp["x"]))
    full, _, _ = ex.run(t, tp, prog.init(tp), tb)
    assert not torch.equal(ps["x"], full["x"])


def test_executor_fo_subset_averages_live_shards_only():
    tp, tb, jp, jb = problem()
    prog = R.ho_sgd_program(quad_loss, HOSGDConfig(**cfg_kw()))
    jprog = JR.ho_sgd_program(jquad_loss, JCfg(**cfg_kw()))
    live = [1, 3]
    ps, _, met = R.RoundExecutor(prog).run(0, tp, prog.init(tp), tb, workers=live)
    jps, _, jmet = JR.RoundExecutor(jprog).run(0, jp, jprog.init(jp), jb, workers=live)
    assert met["order"] == 1 and met["comm_bytes"] == jmet["comm_bytes"] == 4 * DIM
    np.testing.assert_allclose(ps["x"].numpy(), np.asarray(jps["x"]), rtol=1e-6, atol=1e-7)


def test_executor_zo_stale_views_change_the_coefficients():
    tp, tb, jp, jb = problem()
    prog = R.ho_sgd_program(quad_loss, HOSGDConfig(**cfg_kw()))
    jprog = JR.ho_sgd_program(jquad_loss, JCfg(**cfg_kw()))
    ex, st = R.RoundExecutor(prog), prog.init(tp)
    cur, _, _ = ex.run(1, tp, st, tb)
    lag, _, _ = ex.run(1, tp, st, tb, views={2: {"x": tp["x"] + 0.25}})
    assert not torch.equal(cur["x"], lag["x"])
    jlag, _, _ = JR.RoundExecutor(jprog).run(1, jp, jprog.init(jp), jb,
                                             views={2: {"x": jp["x"] + 0.25}})
    assert_update_close(lag["x"].numpy(), jlag["x"], np.asarray(jp["x"]))


def test_executor_cache_keyed_by_round_object():
    """The reference's regression (rounds cached by ``id(rnd)`` ran a dead
    round's local): round i, built fresh after round i-1 was dropped, runs
    its own local at step i."""
    def make_round(i):
        def local(t, worker, model, shard):
            return torch.full((2,), float(i)), torch.zeros(())

        def apply(t, params, state, reduced, workers, aux):
            return params, state, {"val": reduced[0, 0]}

        return R.Round(f"c{i}", 1, "none", local, apply)

    cell = {"rnd": None}
    prog = R.RoundProgram("cache", 1, lambda p: {},
                          lambda t, state: R.RoundStep(cell["rnd"], t, {}),
                          lambda t: 0.0, lambda t: 0.0, lambda t: 0.0)
    ex = R.RoundExecutor(prog)
    params, batch = {"x": torch.zeros(2)}, {"t": torch.zeros(1, 2)}
    for i in range(20):
        cell["rnd"] = None
        gc.collect()
        cell["rnd"] = make_round(i)
        _, _, met = ex.run(0, params, {}, batch)
        assert float(met["val"]) == float(i)


# --------------------------------------------------------------------------- #
# collective semantics
# --------------------------------------------------------------------------- #
def test_neighbor_mix_ring_closed_form():
    out = R.neighbor_mix({"v": torch.arange(4.0)[:, None]}, 4)["v"][:, 0]
    np.testing.assert_allclose(out.numpy(), [4 / 3, 1.0, 2.0, 5 / 3], rtol=1e-6)
    np.testing.assert_allclose(R.neighbor_mix({"v": torch.arange(2.0)[:, None]}, 2)["v"][:, 0],
                               [0.5, 0.5])
    one = R.neighbor_mix({"v": torch.ones(1, 3)}, 1)
    assert torch.equal(one["v"], torch.ones(1, 3))
    x = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32)
    np.testing.assert_allclose(R.neighbor_mix({"v": torch.from_numpy(x)}, 5)["v"].numpy(),
                               np.asarray(JR.neighbor_mix({"v": jnp.asarray(x)}, 5)["v"]),
                               rtol=1e-6)


def test_gossip_pa_round_mixes_ring_neighbors():
    from repro_torch.core.baselines import pa_sgd_program

    tp, tb, _, _ = problem()
    prog = pa_sgd_program(quad_loss, M, tau=1, lr=0.0, gossip=True)
    state = {"replicas": {"x": torch.arange(M, dtype=torch.float32)[:, None].expand(M, DIM)
                          .clone()}}
    _, st2, met = R.RoundExecutor(prog).run(0, tp, state, tb)
    assert met["comm_bytes"] == 2 * 4 * DIM           # two neighbor models
    np.testing.assert_allclose(st2["replicas"]["x"][:, 0].numpy(),
                               [4 / 3, 1.0, 2.0, 5 / 3], rtol=1e-6)
    assert torch.equal(state["replicas"]["x"][:, 0], torch.arange(M, dtype=torch.float32))


def test_masked_average_matches_reference():
    x = np.random.default_rng(2).normal(size=(3, 5)).astype(np.float32)
    x[0, :2] = 0.0
    x[1, 0] = 0.0
    x[2, 0] = 0.0                                     # nobody sent coordinate 0
    w = [1.0, 2.0, 3.0]
    avg, wsum = R.masked_average({"v": torch.from_numpy(x)}, w)
    javg, jwsum = JR.masked_average({"v": jnp.asarray(x)}, jnp.asarray(w))
    np.testing.assert_allclose(avg["v"].numpy(), np.asarray(javg["v"]), rtol=1e-6)
    np.testing.assert_array_equal(wsum["v"].numpy(), np.asarray(jwsum["v"]))
    assert float(avg["v"][0]) == 0.0 and float(wsum["v"][0]) == 0.0


@pytest.mark.parametrize("collective,mode,n_active", [
    ("all_reduce", "per_worker", 4), ("all_reduce", "legacy", 4),
    ("tree_average", "per_worker", 3), ("tree_average", "legacy", 3),
    ("masked_average", "per_worker", 3), ("neighbor_exchange", "per_worker", 4),
    ("neighbor_exchange", "per_worker", 2)])
@pytest.mark.parametrize("codec", [None, "qsgd"])
def test_wire_nbytes_equal_reference(collective, mode, n_active, codec):
    noop = lambda *a: None
    tc, jc = (None, None) if codec is None else (C.qsgd(8), JC.qsgd(8))
    rnd = R.Round("r", 1, collective, noop, noop, wire=R.Wire(tc, mode))
    jrnd = JR.Round("r", 1, collective, noop, noop, wire=JR.Wire(jc, mode))
    payload = {"a": torch.zeros(DIM), "b": torch.zeros(7, 3)}
    jpayload = {"a": jnp.zeros((DIM,)), "b": jnp.zeros((7, 3))}
    assert R.wire_nbytes(rnd, payload, n_active) == JR.wire_nbytes(jrnd, jpayload, n_active)
    gather = R.Round("r", 0, "all_gather", noop, noop)
    assert R.wire_nbytes(gather, {"c": torch.zeros(())}, 3) == 12


def test_wire_codec_collective_matrix():
    noop = lambda *a: None
    for collective in ("all_gather", "none"):
        with pytest.raises(ValueError, match="Wire codec"):
            R.Round("r", 0, collective, noop, noop, wire=R.Wire(C.qsgd(8)))
    with pytest.raises(ValueError, match="wire mode"):
        R.Wire(C.qsgd(8), "sideways")
    sg = R.Round("r", 1, "tree_average", noop, noop, wire=R.Wire(C.signsgd(), "per_worker"))
    got = R.reduce_payloads(sg, torch.tensor([[0.5, -2.0], [1.5, -0.25]]), [0, 1], 0)
    np.testing.assert_allclose(got.numpy(), [1.0625, -1.0625], rtol=1e-6)


def test_federated_specs_raise_until_their_port():
    """Ported (core/federated): a spec whose cohort_k is not m is refused,
    as the reference asserts; a matching one makes the program federated."""
    from repro_torch.core.federated import ClientSampling

    cs = ClientSampling(n_clients=64, cohort_k=M)
    with pytest.raises(ValueError, match="cohort_k"):
        R.ho_sgd_program(quad_loss, HOSGDConfig(**cfg_kw(m=M + 1)), client_sampling=cs)
    with pytest.raises(ValueError, match="cohort_k"):
        R.RoundProgram("f", 1, None, None, None, None, None, client_sampling=cs)
    assert R.ho_sgd_program(quad_loss, HOSGDConfig(**cfg_kw()),
                            client_sampling=cs).client_sampling is cs


# --------------------------------------------------------------------------- #
# the ledger
# --------------------------------------------------------------------------- #
def test_ledger_books_like_reference():
    def book(c, zeros):
        def fake_step(x):
            c.note("all_gather", zeros((4,)), tag="coeffs")
            c.note("pmean", zeros(()), tag="loss", payload=False)
            return x
        return fake_step

    led, jled = CommLedger(), JLedger()
    step = led.wrap("zo", book(coll, lambda s: torch.zeros(s)))
    jstep = jled.wrap("zo", book(jcoll, lambda s: jnp.zeros(s, jnp.float32)))
    for _ in range(3):
        step(1.0)
        jstep(1.0)
    for name in ("bytes_per_step", "by_kind"):
        assert getattr(led, name)("zo") == getattr(jled, name)("zo")
    assert led.bytes_per_step("zo") == 16 and led.bytes_per_step("zo", False) == 20
    assert led.total_bytes() == jled.total_bytes() == 48
    assert led.summary()["zo"]["bytes_total"] == jled.summary()["zo"]["bytes_total"]
    led.reset()
    assert led.total_bytes() == 0 and led.bytes_per_step("zo") == 16
    assert coll.note("all_reduce", torch.zeros(4)).shape == (4,)   # outside a wrap


def test_collectives_need_a_process_group():
    """Ported (a torch.distributed group, tests/test_torch_distributed.py):
    without an initialised group and a mesh over it they raise."""
    for fn in (coll.psum, coll.pmean, coll.all_gather):
        with pytest.raises(RuntimeError, match="process group"):
            fn(torch.zeros(3), "data", mesh=None)


def test_round_executor_books_nbytes_times_active_workers():
    from repro.core.baselines import qsgd_program as jqsgd_program
    from repro_torch.core.baselines import qsgd_program

    d, m, s = 64, 4, 8
    for mode, active in [("per_worker", None), ("per_worker", [0, 2, 3]), ("legacy", None)]:
        totals = []
        for prog, params, batch, led in (
                (qsgd_program(quad_loss, m, s, 0.1, compress_mode=mode),
                 {"x": torch.zeros(d)}, {"t": torch.ones(2 * m, d)}, CommLedger()),
                (jqsgd_program(jquad_loss, m, s, 0.1, compress_mode=mode),
                 {"x": jnp.zeros((d,))}, {"t": jnp.ones((2 * m, d))}, JLedger())):
            ex = (R if isinstance(led, CommLedger) else JR).RoundExecutor(prog)
            run = led.wrap("q", lambda *a, **k: ex.run(*a, **k))
            _, _, met = run(0, params, {}, batch, workers=active)
            totals.append((met["comm_bytes"], led.bytes_per_step("q"), led.total_bytes()))
        assert totals[0] == totals[1]
        mult = 1 if mode == "legacy" else len(active or range(m))
        assert totals[0][0] == C.qsgd(s).nbytes(d) * mult


def test_comm_report_matches_reference():
    led, jled = CommLedger(), JLedger()
    for ledger, note, zeros in ((led, coll.note, lambda n: torch.zeros(n)),
                                (jled, jcoll.note, lambda n: jnp.zeros((n,), jnp.float32))):
        fo = ledger.wrap("fo", lambda: note("all_reduce", zeros(DIM)))
        zo = ledger.wrap("zo", lambda: note("all_gather", zeros(M)))
        for t in range(9):
            (fo if t % 4 == 0 else zo)()
    assert comm_report(led, DIM, M, 4) == jcomm_report(jled, DIM, M, 4)
    assert comm_report(led, DIM, M, 4, codec=C.qsgd(8), leaf_dims=[DIM]) == \
        jcomm_report(jled, DIM, M, 4, codec=JC.qsgd(8), leaf_dims=[DIM])


# --------------------------------------------------------------------------- #
# codecs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", [("qsgd", {"s": 4}), ("qsgd", {"s": 16}),
                                     ("signsgd", {}), ("topk", {"frac": 0.1})])
def test_codec_roundtrip_and_wire_budget(name, kw):
    comp, jcomp = C.get_compressor(name, **kw), JC.get_compressor(name, **kw)
    assert comp.name == jcomp.name
    g = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    dec = comp.decode(comp.encode(g, 7))
    assert dec.shape == g.shape and dec.dtype == torch.float32 and bool(torch.isfinite(dec).all())
    for d in (1, 7, 4096, 1_690_000):
        assert comp.nbytes(d) == jcomp.nbytes(d)
    assert comp.nbytes(4096) < 4 * 4096


def test_qsgd_given_the_reference_uniforms_matches_it(monkeypatch):
    """The draw is ``u < frac`` on uniforms: fed jax's uniforms for the same
    key, the port's QSGD code decodes to the reference's values."""
    g = np.random.default_rng(1).normal(size=512).astype(np.float32)
    jkey = jax.random.key(5)
    monkeypatch.setattr(C, "uniform", lambda key, shape, device: torch.from_numpy(
        np.array(jax.random.uniform(jkey, tuple(shape)))))
    for s in (4, 8):
        got = C.qsgd(s).decode(C.qsgd(s).encode(torch.from_numpy(g), 0))
        want = JC.qsgd(s).decode(JC.qsgd(s).encode(jnp.asarray(g), jkey))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_signsgd_keeps_signs_topk_keeps_largest():
    g = torch.tensor([3.0, -2.0, 0.5, -0.1])
    s_dec = C.signsgd().decode(C.signsgd().encode(g, 0))
    assert torch.equal(torch.sign(s_dec), torch.sign(g))
    t = C.topk(k=2)
    np.testing.assert_allclose(t.decode(t.encode(g, 0)).numpy(), [3.0, -2.0, 0.0, 0.0])
    tree = {"a": torch.ones(64, 8), "b": torch.ones(100)}
    out, nbytes = C.compress_tree(C.signsgd(), tree, 0)
    assert sorted(out) == ["a", "b"] and out["a"].shape == (64, 8)
    assert nbytes == (4 + 512 // 8) + (4 + (100 + 7) // 8)
    assert C.get_compressor("none") is None and C.get_compressor(None) is None
    with pytest.raises(ValueError):
        C.get_compressor("zip")


def test_wire_keys_fold_worker_identity():
    """Worker w at step t encodes with fold(fold(seed, t), w) whoever else is
    live (the reference's identity keying)."""
    calls = []
    codec = C.Compressor("spy", lambda g, key: calls.append(int(key)) or g, lambda c: c,
                         lambda d: 4 * d)
    rnd = R.Round("r", 1, "all_reduce", None, None, wire=R.Wire(codec, "per_worker", seed=3))
    R.reduce_payloads(rnd, {"x": torch.zeros(2, 5)}, [1, 3], R._wire_key(rnd.wire, None, 7))
    assert calls == [D.fold(D.fold(D.fold(3, 7), w), 0) for w in (1, 3)]


# --------------------------------------------------------------------------- #
# package rule
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("module", [
    "repro_torch.core.rounds", "repro_torch.core.baselines", "repro_torch.dist.compress",
    "repro_torch.dist.collectives", "repro_torch.core.engine", "repro_torch.kernels.zo_direction",
    "repro_torch.metrics.logging", "repro_torch.core.federated", "repro_torch.core.distributed",
    "repro_torch.dist.sharding", "repro_torch.data.pipeline", "repro_torch.launch.mesh"])
def test_new_modules_import_neither_jax_nor_repro(module):
    code = (f"import sys, importlib\nimportlib.import_module({module!r})\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
