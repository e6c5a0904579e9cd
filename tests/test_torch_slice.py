"""The HO-SGD slice of the port against the JAX package, on the CPU.

The whole Fig. 2 training path at small width — covtype, the 2-layer tanh
MLP at hidden=64, m=4, tau=4, 8 steps — runs in both packages from the same
initial parameters (JAX's, carried across with ``repro_torch.convert``) on
the same numpy batches, for every port engine and momentum 0 / 0.9.  Loss
trajectories agree to rtol 1e-4 and the FO/ZO order sequence is identical.
Parameters agree to rtol 5e-3 / atol 1e-5 (the flat-vs-fused tolerance of
test_engine.py:374-379) without momentum.  With momentum 0.9 they are held
to the update-scaled rule of test_zo_acc_dtype.py (2% of the largest update
of the leaf): each ZO coefficient c = (d/mu)(f1 - f0) turns an ulp of the
loss (the two frameworks reduce in different orders) into ~1 unit of c at
d/mu = 8.1e6, and momentum carries that noise over ten steps, so single
parameters move by up to ~2.6e-5 between the packages (measured).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import ho_sgd as J
from repro.data.synthetic import batches, make_classification
from repro.models.mlp import init_mlp_classifier as jinit, mlp_loss as jmlp_loss
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core import ho_sgd as T
from repro_torch.models.mlp import mlp_loss

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

M, B, TAU, STEPS, HIDDEN, LR, MU = 4, 16, 4, 8, 64, 0.05, 1e-3


@pytest.fixture(scope="module")
def slice_setup():
    ds = make_classification("covtype")
    p0 = jinit(jax.random.key(0), ds.n_features, ds.n_classes, hidden=HIDDEN)
    d = sum(int(x.size) for x in jax.tree.leaves(p0))
    return ds, p0, d


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("engine", ["tree", "fused", "pallas", "flat"])
def test_fig2_slice_matches_jax(slice_setup, engine, momentum):
    ds, p0, d = slice_setup
    kw = dict(tau=TAU, mu=MU, m=M, lr=LR, zo_lr=LR * 30.0 / d, momentum=momentum,
              engine=engine)
    jh = J.run_method(J.make_ho_sgd(jmlp_loss, J.HOSGDConfig(**kw)), p0,
                      batches(ds, M * B, seed=1), STEPS)
    th = T.run_method(T.make_ho_sgd(mlp_loss, T.HOSGDConfig(**kw)),
                      params_from_numpy(p0, device="cpu"),
                      batches(ds, M * B, seed=1), STEPS)
    assert th["order"] == jh["order"] == [1 if t % TAU == 0 else 0 for t in range(STEPS)]
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    got = tree_to_numpy(th["params"])
    for k in sorted(got):
        want = np.asarray(jh["params"][k])
        if momentum == 0.0:
            np.testing.assert_allclose(got[k], want, rtol=5e-3, atol=1e-5, err_msg=k)
        else:
            _assert_update_close(got[k], want, np.asarray(p0[k]), k)


def _assert_update_close(got, want, start, what):
    """|got - want| <= 2% of the largest update of the leaf (+1e-7)."""
    scale = max(float(np.abs(want - start).max()), 1e-12)
    diff = float(np.abs(got - want).max())
    assert diff <= 0.02 * scale + 1e-7, (what, diff, scale)


def test_jax_run_continues_in_the_port(slice_setup):
    """Params and momentum state of a JAX run carried across mid-run: the
    port's continuation tracks the JAX run that kept going."""
    ds, p0, d = slice_setup
    kw = dict(tau=TAU, mu=MU, m=M, lr=LR, zo_lr=LR * 30.0 / d, momentum=0.9,
              engine="flat")
    jm = J.make_ho_sgd(jmlp_loss, J.HOSGDConfig(**kw))
    tm = T.make_ho_sgd(mlp_loss, T.HOSGDConfig(**kw))
    data = list(zip(range(STEPS), batches(ds, M * B, seed=1)))
    params, state = p0, jm.init(p0)
    jl = []
    for t, b in data:
        if t == 3:
            tp, ts = params_from_numpy(params, "cpu"), params_from_numpy(state, "cpu")
        params, state, met = jm.step(t, params, state, b)
        jl.append(float(met["loss"]))
    tl = []
    for t, b in data[3:]:
        tp, ts, met = tm.step(t, tp, ts, b)
        tl.append(float(met["loss"]))
    np.testing.assert_allclose(tl, jl[3:], rtol=1e-4)
    got_p, got_s = tree_to_numpy(tp), tree_to_numpy(ts)
    for k in sorted(got_p):
        _assert_update_close(got_p[k], np.asarray(params[k]), np.asarray(p0[k]), k)
        _assert_update_close(got_s[k], np.asarray(state[k]), 0.0, k + " momentum")
