"""The port's baselines against the JAX package's, on the CPU.

Each baseline runs 8 steps from the same start on the same batches in both
packages (the quadratic problem of tests/test_baselines.py, D=32, m=4, B=8):

* PA-SGD, gossip-PA: first-order, deterministic: params rtol 1e-5 / atol
  1e-6, losses rtol 1e-5, ``comm_bytes`` per step equal as integers;
* RI-SGD and QSGD draw with ``jax.random`` in the reference and with
  ``torch.Generator``s here, so the port is handed the reference's draws
  (RI's index arrays, QSGD's uniforms for ``u < frac``) and held to the same
  tolerances (QSGD's quantization levels are exact; its decoded values differ
  by the ulps of the norm);
* ZO-SVRG-Ave: losses rtol 1e-4, params to 2% of the update (the
  coefficient (d/mu)(f1-f0) turns loss ulps into update noise, as in
  test_torch_ho_sgd.py).

Plus the quantizer's unbiasedness (as test_comm_ledger.py and
test_baselines.py pin it), ``ri_shard_batch`` given the reference's indices,
PA-SGD at tau=1 equal to sync-SGD, and the Table-1 cost hooks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import run_method as jrun_method
from repro.core import make_sync_sgd as jmake_sync_sgd
from repro_torch.core import baselines as TB
from repro_torch.core import directions as D
from repro_torch.core import make_sync_sgd, run_method
from repro_torch.dist import compress as C

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

D_, M, B, STEPS = 32, 4, 8, 8


def quad_loss(params, batch):
    return 0.5 * torch.mean(torch.sum((params["x"] - batch["t"]) ** 2, -1))


def jquad_loss(params, batch):
    return 0.5 * jnp.mean(jnp.sum((params["x"] - batch["t"]) ** 2, -1))


def quad_batches(m, b, d, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield {"t": (1.0 + 0.1 * rng.normal(size=(m * b, d))).astype(np.float32)}


def both(tmeth, jmeth, x0=0.0, steps=STEPS):
    """Run the two methods on the same batches; per-step comm_bytes too."""
    out = []
    for meth, p0, tensor in ((tmeth, {"x": torch.full((D_,), x0)}, True),
                             (jmeth, {"x": jnp.full((D_,), x0)}, False)):
        params, state = p0, meth.init(p0)
        hist = {"loss": [], "comm_bytes": []}
        data = quad_batches(M, B, D_)
        for t in range(steps):
            params, state, met = meth.step(t, params, state, next(data))
            hist["loss"].append(float(met["loss"]))
            hist["comm_bytes"].append(met.get("comm_bytes"))
        hist["x"] = params["x"].numpy() if tensor else np.asarray(params["x"])
        out.append(hist)
    return out


def assert_update_close(got, want, start):
    scale = max(float(np.abs(want - start).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= 0.02 * scale + 1e-7


@pytest.mark.parametrize("gossip", [False, True])
def test_pa_sgd_matches_reference(gossip):
    make_t = TB.make_gossip_pa_sgd if gossip else TB.make_pa_sgd
    make_j = JB.make_gossip_pa_sgd if gossip else JB.make_pa_sgd
    th, jh = both(make_t(quad_loss, M, tau=3, lr=0.3), make_j(jquad_loss, M, tau=3, lr=0.3))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(th["x"], jh["x"], rtol=1e-5, atol=1e-6)
    assert th["comm_bytes"] == jh["comm_bytes"]
    per_sync = (2 if gossip else 1) * 4 * D_
    assert th["comm_bytes"] == [per_sync if (t + 1) % 3 == 0 else 0 for t in range(STEPS)]


def _jax_ri_draws(monkeypatch):
    """Hand the port the reference's RI draws: at step t (no key given) the
    port keys with fold(t, t), the reference with fold_in(key(t), t)."""
    jkeys = {D.fold(t, t): jax.random.fold_in(jax.random.key(t), t) for t in range(STEPS)}

    def draw(key, m, n_red, high):
        return torch.from_numpy(np.array(jax.random.randint(jkeys[key], (m, n_red), 0, high),
                                         np.int64))
    monkeypatch.setattr(TB, "ri_indices", draw)


def test_ri_sgd_matches_reference_given_its_draws(monkeypatch):
    _jax_ri_draws(monkeypatch)
    th, jh = both(TB.make_ri_sgd(quad_loss, M, tau=4, lr=0.3, mu_r=0.25),
                  JB.make_ri_sgd(jquad_loss, M, tau=4, lr=0.3, mu_r=0.25))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(th["x"], jh["x"], rtol=1e-5, atol=1e-6)
    assert th["comm_bytes"] == jh["comm_bytes"]


def test_ri_shard_batch_given_the_reference_indices(monkeypatch):
    batch = np.arange(32, dtype=np.float32).reshape(32, 1).repeat(D_, 1)
    jkey = jax.random.key(1)
    monkeypatch.setattr(TB, "ri_indices", lambda key, m, n_red, high: torch.from_numpy(
        np.array(jax.random.randint(jkey, (m, n_red), 0, high), np.int64)))
    got = TB.ri_shard_batch({"t": torch.from_numpy(batch)}, 4, 0.25, 0)["t"]
    want = JB.ri_shard_batch({"t": batch}, 4, 0.25, jkey)["t"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got.numpy() != batch).any())
    monkeypatch.undo()
    same = TB.ri_shard_batch({"t": torch.ones(16, D_)}, 4, 0.0, 0)
    assert torch.equal(same["t"], torch.ones(16, D_))
    # the draw is a CPU generator's: the same indices whatever the device
    assert torch.equal(TB.ri_indices(5, 4, 2, 32), TB.ri_indices(5, 4, 2, 32))


def test_qsgd_matches_reference_given_its_uniforms(monkeypatch):
    """Worker w at step t, leaf i: the port keys fold(fold(fold(0, t), w), i),
    the reference fold_in(fold_in(fold_in(key(0), t), w), i)."""
    jkeys = {}
    for t in range(STEPS):
        for w in range(M):
            jkeys[D.fold(D.fold(D.fold(0, t), w), 0)] = jax.random.fold_in(
                jax.random.fold_in(jax.random.fold_in(jax.random.key(0), t), w), 0)
    monkeypatch.setattr(C, "uniform", lambda key, shape, device: torch.from_numpy(
        np.array(jax.random.uniform(jkeys[key], tuple(shape)))))
    th, jh = both(TB.make_qsgd(quad_loss, M, s=8, lr=0.3), JB.make_qsgd(jquad_loss, M, s=8, lr=0.3))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(th["x"], jh["x"], rtol=1e-5, atol=1e-6)
    assert th["comm_bytes"] == jh["comm_bytes"] == [C.qsgd(8).nbytes(D_) * M] * STEPS


def test_zo_svrg_ave_matches_reference():
    """From x0=1.5 (loss ~4): f1 - f0 is ~1e-3 here, so an ulp of the loss
    (4.8e-7) is ~0.05% of a coefficient; from test_baselines.py's x0=3
    (loss ~64) the same ulps already reach 4.6% of the first update."""
    dataset = {"t": np.ones((64, D_), np.float32)}
    th, jh = both(TB.make_zo_svrg_ave(quad_loss, M, mu=1e-3, lr=0.06 / D_, dataset=dataset,
                                      epoch_len=5),
                  JB.make_zo_svrg_ave(jquad_loss, M, mu=1e-3, lr=0.06 / D_, dataset=dataset,
                                      epoch_len=5), x0=1.5)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert_update_close(th["x"], jh["x"], np.full(D_, 1.5, np.float32))
    assert th["comm_bytes"] == [None] * STEPS


def test_qsgd_quantization_is_unbiased():
    """Stochastic rounding: the mean over keys converges on g (as
    test_comm_ledger.py pins it), and the levels live on the s-level grid."""
    g = torch.from_numpy(np.random.default_rng(1).normal(size=512).astype(np.float32))
    comp = C.qsgd(4)
    dec = torch.stack([comp.decode(comp.encode(g, k)) for k in range(64)])
    err = dec.mean(0) - g
    assert float(err.abs().max()) < 0.2 * float(torch.linalg.norm(g)) / 4
    qs = torch.stack([TB.quantize_qsgd(g, 8, k) for k in range(512)])
    err = qs.mean(0) - g
    assert float(err.abs().mean()) < 0.06 and float(err.abs().max()) < 0.4
    lv = qs[0].abs() / torch.linalg.norm(g) * 8
    assert float((lv - torch.round(lv)).abs().max()) < 1e-4


def test_quantize_qsgd_given_the_reference_uniforms(monkeypatch):
    g = np.random.default_rng(2).normal(size=300).astype(np.float32)
    jkey = jax.random.key(3)
    monkeypatch.setattr(C, "uniform", lambda key, shape, device: torch.from_numpy(
        np.array(jax.random.uniform(jkey, tuple(shape)))))
    np.testing.assert_allclose(TB.quantize_qsgd(torch.from_numpy(g), 8, 0).numpy(),
                               np.asarray(JB.quantize_qsgd(jnp.asarray(g), 8, jkey)),
                               rtol=1e-6, atol=1e-7)


def test_pa_sgd_tau1_equals_sync():
    pa = TB.make_pa_sgd(quad_loss, M, tau=1, lr=0.3)
    sy = make_sync_sgd(quad_loss, M, lr=0.3)
    h1 = run_method(pa, {"x": torch.zeros(D_)}, quad_batches(M, B, D_), 15)
    h2 = run_method(sy, {"x": torch.zeros(D_)}, quad_batches(M, B, D_), 15)
    np.testing.assert_allclose(h1["params"]["x"].numpy(), h2["params"]["x"].numpy(), rtol=1e-5)
    jh = jrun_method(jmake_sync_sgd(jquad_loss, M, lr=0.3), {"x": jnp.zeros((D_,))},
                     quad_batches(M, B, D_), 15)
    np.testing.assert_allclose(h1["params"]["x"].numpy(), np.asarray(jh["params"]["x"]),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["pa", "gossip", "ri", "qsgd", "zo_svrg"])
def test_cost_hooks_match_reference(name):
    build = {
        "pa": lambda mod, f: mod.make_pa_sgd(f, M, tau=8, lr=0.1),
        "gossip": lambda mod, f: mod.make_gossip_pa_sgd(f, M, tau=8, lr=0.1),
        "ri": lambda mod, f: mod.make_ri_sgd(f, M, tau=8, lr=0.1, mu_r=0.25),
        "qsgd": lambda mod, f: mod.make_qsgd(f, M, s=8, lr=0.1),
        "zo_svrg": lambda mod, f: mod.make_zo_svrg_ave(f, M, mu=1e-3, lr=1e-3, dataset=None),
    }[name]
    t, j = build(TB, quad_loss), build(JB, jquad_loss)
    assert t.name == j.name
    for d in (32, 1_771_907):
        assert (t.comm_scalars(d), t.fevals(d), t.gevals(d)) == \
            (j.comm_scalars(d), j.fevals(d), j.gevals(d))
    assert (t.program is None) == (j.program is None)
