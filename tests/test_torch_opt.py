"""repro_torch.opt.optimizers against repro.opt.optimizers on the CPU.

Schedules agree exactly (both compute in float32); SGD(+momentum) and Adam
updates to rtol 1e-6 on the same gradients, made with numpy.  The copied
``core/theory.py`` formulas agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.opt import optimizers as J
from repro_torch.opt import optimizers as T

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("name,args", [
    ("const_schedule", (0.05,)),
    ("invsqrt_schedule", (0.1, 10)),
    ("cosine_schedule", (0.1, 100, 10, 0.1)),
])
def test_schedules_match_jax(name, args):
    ts, js = getattr(T, name)(*args), getattr(J, name)(*args)
    for t in [0, 1, 5, 10, 11, 50, 99, 100, 150]:
        got, want = ts(t), js(jnp.int32(t))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6), (name, t)


def test_theorem_lr():
    assert T.theorem_lr(64, 4, 10_000, 2.0) == J.theorem_lr(64, 4, 10_000, 2.0)


@pytest.mark.parametrize("kind", ["sgd", "sgd_momentum", "adam"])
def test_optimizer_updates_match_jax(kind):
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    make = {"sgd": lambda M: M.sgd(M.const_schedule(0.1)),
            "sgd_momentum": lambda M: M.sgd(M.const_schedule(0.1), 0.9),
            "adam": lambda M: M.adam(M.const_schedule(1e-2))}[kind]
    topt, jopt = make(T), make(J)
    assert topt.kind == jopt.kind and set(topt.hyper) == set(jopt.hyper)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, js = topt.init(tp), jopt.init(jp)
    for t in range(4):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
        td, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, t)
        jd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.int32(t))
        tp, jp = T.apply_deltas(tp, td), J.apply_deltas(jp, jd)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_apply_deltas_keeps_leaf_dtype():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    out = T.apply_deltas(p, {"w": torch.full((4,), 0.5)})
    assert out["w"].dtype == torch.bfloat16 and torch.all(out["w"] == 1.5)


@pytest.mark.parametrize("d,m,B,N,tau", [(1000, 8, 16, 10_000_000, 8),
                                         (1_771_907, 4, 64, 10**9, 8),
                                         (900, 5, 5, 300, 1)])
def test_theory_copy_matches_jax_package(d, m, B, N, tau):
    """core/theory.py is copied into the port; every formula agrees."""
    from repro.core import theory as JT
    from repro_torch.core import theory as TT

    jp, tp = JT.Problem(d=d, m=m, B=B, N=N), TT.Problem(d=d, m=m, B=B, N=N)
    assert TT.min_iterations(tp) == JT.min_iterations(jp)
    assert TT.theorem_mu(tp) == JT.theorem_mu(jp)
    assert TT.theorem1_bound(tp, tau) == JT.theorem1_bound(jp, tau)
    assert TT.convergence_order(tp, tau) == JT.convergence_order(jp, tau)
    for meth in ("ho_sgd", "ri_sgd", "sync_sgd", "zo_sgd", "zo_svrg_ave", "qsgd"):
        assert TT.table1_row(meth, tp, tau) == JT.table1_row(meth, jp, tau)


def test_convert_carries_bf16_leaves_and_optimizer_state():
    """params_from_numpy takes JAX/numpy trees of any shape — bf16 leaves bit
    for bit, Adam's (mu, nu) pair, the empty SGD state — and never aliases."""
    from repro_torch.convert import params_from_numpy, tree_to_numpy

    w = jnp.linspace(-1.0, 1.0, 7).astype(jnp.bfloat16)
    got = params_from_numpy({"w": w, "n": {"s": np.float32(2.5) * np.ones(2, np.float32)}},
                            device="cpu")
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(), np.asarray(w, np.float32))
    state = J.adam(J.const_schedule(1e-2)).init({"a": jnp.ones((2, 3))})
    tstate = params_from_numpy(state, device="cpu")
    assert isinstance(tstate, tuple) and tstate[0]["a"].shape == (2, 3)
    assert params_from_numpy((), device="cpu") == ()
    src = torch.ones(3)
    out = params_from_numpy({"x": src}, device="cpu")
    out["x"].add_(1.0)
    assert torch.all(src == 1.0)
    assert tree_to_numpy(got)["n"]["s"].tolist() == [2.5, 2.5]
