"""repro_torch.core.ho_sgd and core.zo_grad against the JAX package, on the CPU.

Mirrors the algorithm-semantics tests of test_ho_sgd.py (tau=1 is sync-SGD,
the hybrid converges and beats ZO-only, the Table 1 cost model, the
adaptive-tau schedule living in the method state, two function evaluations
per worker per ZO step) and holds the ZO-gradient helpers of core/zo_grad.py
against JAX's.  The whole Fig. 2 slice is in test_torch_slice.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ho_sgd as J
from repro.core import zo_grad as JZ
from repro_torch.core import ho_sgd as T
from repro_torch.core import zo_grad as TZ

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

D_ = 64


def quad_loss(params, batch):
    return 0.5 * torch.mean(torch.sum((params["x"] - batch["t"]) ** 2, -1))


def jquad_loss(params, batch):
    return 0.5 * jnp.mean(jnp.sum((params["x"] - batch["t"]) ** 2, -1))


def quad_batches(m, B, d, noise=0.1, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield {"t": (1.0 + noise * rng.normal(size=(m * B, d))).astype(np.float32)}


def p0():
    return {"x": torch.zeros(D_)}


def test_tau1_equals_sync_sgd_trajectory():
    ho = T.make_ho_sgd(quad_loss, T.HOSGDConfig(tau=1, m=4, lr=0.3))
    sync = T.make_sync_sgd(quad_loss, 4, lr=0.3)
    h1 = T.run_method(ho, p0(), quad_batches(4, 8, D_), 20)
    h2 = T.run_method(sync, p0(), quad_batches(4, 8, D_), 20)
    assert torch.equal(h1["params"]["x"], h2["params"]["x"])
    assert all(o == 1 for o in h1["order"])


def test_hybrid_converges_and_beats_zo_only():
    m, B, iters = 4, 8, 160
    cfg = dict(tau=8, m=m, lr=0.3, zo_lr=0.3 / 8, mu=1e-4)
    hy = T.run_method(T.make_ho_sgd(quad_loss, T.HOSGDConfig(**cfg)), p0(),
                      quad_batches(m, B, D_), iters)
    zo = T.run_method(T.make_zo_sgd(quad_loss, m, mu=1e-4, lr=0.3 / 8), p0(),
                      quad_batches(m, B, D_), iters)

    def gap(h):
        return float(quad_loss(h["params"], {"t": torch.ones(1, D_)}))

    assert gap(hy) < 0.05 and gap(hy) < gap(zo)


def test_cost_model_table1_matches_jax():
    d = 10_000
    for tm, jm in [
        (T.make_ho_sgd(quad_loss, T.HOSGDConfig(tau=8, m=4, lr=0.1)),
         J.make_ho_sgd(jquad_loss, J.HOSGDConfig(tau=8, m=4, lr=0.1))),
        (T.make_sync_sgd(quad_loss, 4, lr=0.1), J.make_sync_sgd(jquad_loss, 4, lr=0.1)),
        (T.make_zo_sgd(quad_loss, 4, mu=1e-3, lr=0.1),
         J.make_zo_sgd(jquad_loss, 4, mu=1e-3, lr=0.1)),
    ]:
        assert tm.name == jm.name
        for f in ("comm_scalars", "fevals", "gevals"):
            assert getattr(tm, f)(d) == getattr(jm, f)(d)


def test_adaptive_tau_schedule_matches_jax_and_lives_in_state():
    for spec in ("const:3", "linear:2,16,50"):
        ts, js = T.parse_tau_schedule(spec), J.parse_tau_schedule(spec)
        assert [ts(t) for t in range(60)] == [js(t) for t in range(60)]
    since = 0
    for t in range(40):
        got = T.adaptive_tau_decision(t, since, 3, 8)
        assert got == J.adaptive_tau_decision(t, since, 3, 8)
        since = got[2]
    meth = T.make_adaptive_ho_sgd(quad_loss, T.HOSGDConfig(tau=8, m=4, lr=0.05,
                                                           zo_lr=0.05 / D_),
                                  tau_schedule=lambda t: 3)

    def orders(state):
        params, out = p0(), []
        for t in range(7):
            params, state, met = meth.step(t, params, state,
                                           next(quad_batches(4, 4, D_, seed=t)))
            out.append(int(met["order"]))
        return out

    assert orders(meth.init(p0())) == orders(meth.init(p0())) == [1, 0, 0, 1, 0, 0, 1]


@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_zo_step_uses_two_fevals_per_worker(engine):
    calls = {"n": 0}

    def counting_loss(params, batch):
        calls["n"] += 1
        return quad_loss(params, batch)

    m = 3
    meth = T.make_ho_sgd(counting_loss, T.HOSGDConfig(tau=1 << 30, m=m, lr=1e-3,
                                                      engine=engine))
    meth.step(1, p0(), meth.init(p0()), next(quad_batches(m, 2, D_)))
    assert calls["n"] == 2 * m


# --------------------------------------------------------------------------- #
# core/zo_grad.py
# --------------------------------------------------------------------------- #
def test_zo_grad_helpers_match_jax():
    """Targets near x keep the loss small, so the (d/mu)-scaled ulps of the
    two frameworks' loss reductions stay below rtol 1e-3 of c."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=D_).astype(np.float32)
    tb = {"t": torch.from_numpy((x + 0.1 * rng.normal(size=(8, D_))).astype(np.float32))}
    jb = {"t": jnp.asarray(tb["t"].numpy())}
    tp, jp = {"x": torch.from_numpy(x)}, {"x": jnp.asarray(x)}
    g, c, f0 = TZ.zo_gradient(quad_loss, tp, tb, seed=3, t=5, worker=2, mu=1e-2)
    jg, jc, jf0 = JZ.zo_gradient(jquad_loss, jp, jb, 3, jnp.int32(5), 2, 1e-2)
    assert float(f0) == pytest.approx(float(jf0), rel=1e-6)
    assert float(c) == pytest.approx(float(jc), rel=1e-3)
    np.testing.assert_allclose(g["x"].numpy(), np.asarray(jg["x"]), rtol=1e-3, atol=1e-6)
    cs = np.asarray([0.5, -1.0, 2.0], np.float32)
    rec = TZ.reconstruct_update(tp, torch.from_numpy(cs), 3, 5)
    jrec = JZ.reconstruct_update(jp, jnp.asarray(cs), 3, jnp.int32(5))
    np.testing.assert_allclose(rec["x"].numpy(), np.asarray(jrec["x"]), rtol=1e-5, atol=1e-6)
    v = {"x": torch.ones(D_) / 8.0}
    c1, f1 = TZ.zo_coefficient(quad_loss, tp, tb, v, 1e-2, D_)
    jc1, jf1 = JZ.zo_coefficient(jquad_loss, jp, jb, {"x": jnp.ones((D_,)) / 8.0}, 1e-2, D_)
    assert float(c1) == pytest.approx(float(jc1), rel=1e-3)
    # the smoothed loss sits near the loss itself for a small mu
    sm = TZ.smoothed_loss(quad_loss, tp, tb, 1e-3, torch.Generator().manual_seed(0), 8)
    assert float(sm) == pytest.approx(float(f0), rel=1e-3)
