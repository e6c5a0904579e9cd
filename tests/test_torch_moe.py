"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's.

The same parameters (``repro.models.moe.init_moe``'s, carried across with
``repro_torch.convert``) and the same numpy-seeded inputs go through both
packages' ``moe_forward``.  Routing is discrete, so each case first holds
the port's expert ids to the reference's (``jax.lax.top_k`` of the
reference's router probabilities) and its kept routes to the reference's
sort-based ranking, then the outputs.

Tolerances:

* float32: y within rtol 1e-5 / atol 1e-5, aux within rtol 1e-6.  Both
  packages compute the same products in other summation orders (~1e-7
  relative each); the largest difference measured was 7.6e-7 on |y| ~ 0.3.
* bfloat16: equal expert ids, then y within 4 bf16 ulps of its row's
  largest |y| (the ulp of a row is that of its largest element).  The
  expert path rounds to bf16 after each of its products, the SiLU, the
  gate weighting and the sum over the k routes, in other orders in the two
  packages: about half the elements differ, by at most 2 such ulps when
  measured (0.0156 on rows up to 1.74).  A row near zero is a sum of k
  gated rows that cancel, so a per-element ulp would read a rounding of
  the summands as tens of ulps of the sum.  A wrong route is off by O(1).
* gradients: within rtol 1e-4 of ``jax.grad``'s, atol 1e-4 of the leaf's
  largest gradient (the trainer tests' rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import moe as JM
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as M

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]


def configs(arch, **kw):
    return jget_config(arch).reduced().with_(**kw), get_config(arch).reduced().with_(**kw)


def inputs(cfg, B=2, S=24, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def ref_routes(jcfg, jp, x):
    """The reference's expert ids and kept-route mask, as its moe_forward
    forms them."""
    xf = jnp.asarray(x).reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    _, ids = jax.lax.top_k(probs, jcfg.top_k)
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    starts = jnp.searchsorted(e_sorted, jnp.arange(jcfg.n_experts, dtype=flat_e.dtype))
    pos_sorted = jnp.arange(flat_e.shape[0], dtype=jnp.int32) - starts.astype(jnp.int32)[e_sorted]
    flat_pos = jnp.zeros(flat_e.shape, jnp.int32).at[order].set(pos_sorted)
    C = JM.moe_capacity(jcfg, xf.shape[0])
    return np.asarray(ids), np.asarray(flat_pos < C)


def port_routes(cfg, tp, x):
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, ids, _ = M.route(cfg, tp, xf)
    _, _, keep, _, _ = M.dispatch(ids, cfg.n_experts, M.moe_capacity(cfg, xf.shape[0]))
    return ids.numpy(), keep.numpy()


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_config(a).is_moe])
@pytest.mark.parametrize("reduced", [False, True])
def test_moe_capacity_matches_reference(arch, reduced):
    assert ARCH_IDS == JARCH_IDS
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for cf in (1.25, 0.5, 1e-9, 2.0):
        for T in (1, 7, 8, 48, 1000, 1024, 8192, 1 << 20):
            got = M.moe_capacity(cfg.with_(capacity_factor=cf), T)
            assert got == JM.moe_capacity(jcfg.with_(capacity_factor=cf), T)
            assert got >= 8 and got % 8 == 0


def test_top_k_breaks_ties_to_the_lower_index():
    """``jax.lax.top_k``'s rule: equal values in index order.  (torch.topk
    returned [3, 5, 4] for this row.)"""
    probs = torch.full((2, 6), 1 / 6)
    vals, idx = M.top_k(probs, 3)
    assert idx.tolist() == [[0, 1, 2]] * 2
    assert np.asarray(jax.lax.top_k(jnp.full((2, 6), 1 / 6), 3)[1]).tolist() == idx.tolist()
    rng = np.random.default_rng(5)
    p = rng.integers(0, 4, (64, 16)).astype(np.float32)        # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(p), 5)
    tv, ti = M.top_k(torch.from_numpy(p), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf", [1.25, 0.5, 1e-9])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, cf):
    """Equal expert ids and kept routes, then y and aux.  At capacity factor
    0.5 and 1e-9 (C = 8: 96 routes for 32 slots) routes drop."""
    jcfg, cfg = configs(arch, capacity_factor=cf)
    jp = JM.init_moe(jax.random.key(1), jcfg, jnp.float32)
    tp = params_from_numpy(jp, device="cpu")
    x = inputs(cfg)
    jids, jkeep = ref_routes(jcfg, jp, x)
    tids, tkeep = port_routes(cfg, tp, x)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tkeep, jkeep)
    if cf < 1:
        assert not tkeep.all()
    jy, jaux = JM.moe_forward(jcfg, jp, jnp.asarray(x))
    ty, taux = M.moe_forward(cfg, tp, torch.from_numpy(x))
    assert ty.shape == x.shape and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_zero_router_ties_route_to_the_lowest_experts():
    """``tests/test_ssm_moe.py``'s uniform router: every expert ties, so
    every token picks experts 0 and 1, which overflow their capacity (32
    routes each for 24 slots); aux is k exactly, and y equals the reference's,
    drops included."""
    jcfg, cfg = configs("arctic-480b")
    jp = JM.init_moe(jax.random.key(4), jcfg, jnp.float32)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = params_from_numpy(jp, device="cpu")
    x = inputs(cfg, 2, 16, seed=3)
    tids, tkeep = port_routes(cfg, tp, x)
    jids, jkeep = ref_routes(jcfg, jp, x)
    assert tids.tolist() == jids.tolist() == [[0, 1]] * 32
    np.testing.assert_array_equal(tkeep, jkeep)
    assert (~tkeep).sum() == 16
    jy, jaux = JM.moe_forward(jcfg, jp, jnp.asarray(x))
    ty, taux = M.moe_forward(cfg, tp, torch.from_numpy(x))
    assert float(taux) == pytest.approx(cfg.top_k, rel=1e-6) == float(jaux)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    # the dropped tokens (the last 8 of the 32 routed to each expert) get nothing
    assert (ty.reshape(32, -1)[24:] == 0).all()


def row_ulps(got, want):
    """|got - want| in bf16 ulps of each row's largest |want|."""
    _, e = np.frexp(np.abs(want).max(-1, keepdims=True))
    return np.abs(got - want) / np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_bf16_matches_reference(arch):
    jcfg, cfg = configs(arch, dtype="bfloat16")
    jp = JM.init_moe(jax.random.key(2), jcfg, jnp.bfloat16)
    tp = params_from_numpy(jp, device="cpu")
    assert tp["router"].dtype == torch.float32 and tp["wg"].dtype == torch.bfloat16
    x = inputs(cfg, seed=6)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    jids, _ = ref_routes(jcfg, jp, np.asarray(jx.astype(jnp.float32)))
    tids, _ = port_routes(cfg, tp, tx.float().numpy())
    np.testing.assert_array_equal(tids, jids)
    jy, jaux = JM.moe_forward(jcfg, jp, jx)
    ty, taux = M.moe_forward(cfg, tp, tx)
    assert ty.dtype == torch.bfloat16
    ulps = row_ulps(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)))
    assert ulps.max() <= 4, ulps.max()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 1e-9])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_reference(arch, cf):
    """Gradients of <y, r> + aux with respect to every parameter and to x,
    against ``jax.grad`` of the reference, with and without drops."""
    jcfg, cfg = configs(arch, capacity_factor=cf)
    jp = JM.init_moe(jax.random.key(7), jcfg, jnp.float32)
    x = inputs(cfg, seed=8)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_forward(jcfg, p, xx)
        return jnp.sum(y * jnp.asarray(r)) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(jp, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.moe_forward(cfg, tp, tx)
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    for name in sorted(jgp):
        a = np.asarray(jgp[name])
        np.testing.assert_allclose(tp[name].grad.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=name)
    a = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), a, rtol=1e-4, atol=1e-4 * np.abs(a).max())
