"""repro_torch.core.engine against repro.core.engine on the CPU.

Each port engine is held against the JAX engine of the same name (the JAX
``flat`` engine runs its Pallas kernels in interpret mode; the port's runs
the plain versions on CPU tensors), and the flat engine's pins from
tests/test_engine.py (:336, :360, :382, :401, :429) are mirrored for the
port.  Tolerances: Gaussians differ by ulps across math libraries, so
primitives agree to rtol 1e-5; step-level pins use test_engine.py's own
rtol 1e-4 on losses and rtol 5e-3 / atol 1e-5 on parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import make_engine as jmake
from repro.core.ho_sgd import HOSGDConfig as JCfg, make_ho_sgd as jmake_ho, run_method as jrun
from repro_torch.core.engine import ENGINES, FlatEngine, PallasEngine, make_engine
from repro_torch.core.ho_sgd import HOSGDConfig, make_ho_sgd, run_method
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SEED, T = 3, 5
SHAPE_SETS = [
    {"w": (37, 3), "b": (129,), "s": ()},
    {"a": (1000,), "c": (261,)},
]


def _np_params(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in sorted(shapes.items())}


def _both(shapes, jdtype=jnp.float32, tdtype=torch.float32):
    p = _np_params(shapes)
    return ({k: jnp.asarray(v).astype(jdtype) for k, v in p.items()},
            {k: torch.from_numpy(v).to(tdtype) for k, v in p.items()})


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("shapes", SHAPE_SETS)
def test_primitives_match_jax_engine(engine, shapes):
    jp, tp = _both(shapes)
    je = jmake(engine, jp, SEED, block=64)
    te = make_engine(engine, tp, SEED, block=64)
    assert te.dim == je.dim and te.sizes == je.sizes and te.offsets == je.offsets
    assert te.salts(T, 2) == [int(s) for s in je.salts(jnp.int32(T), jnp.uint32(2))]
    jinv = float(jax.jit(je.inv_norm)(jnp.int32(T), jnp.uint32(2)))
    tinv = float(te.inv_norm(T, 2))
    assert tinv == pytest.approx(jinv, rel=1e-6)
    scale = 1e-2 * jinv
    jout = jax.jit(lambda p: je.perturb(p, jnp.int32(T), jnp.uint32(1), jnp.float32(scale)))(jp)
    tout = te.perturb(tp, T, 1, torch.tensor(scale, dtype=torch.float32))
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
        _close(a, b, rtol=1e-5, atol=1e-6)
    cs = np.asarray([0.5, -1.0, 2.0, 0.1], np.float32)
    jrec = jax.jit(lambda: je.reconstruct(jnp.asarray(cs), jnp.int32(T)))()
    trec = te.reconstruct(torch.from_numpy(cs), T)
    for a, b in zip(tree_leaves(trec), jax.tree.leaves(jrec)):
        assert a.dtype == torch.float32
        _close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_bf16_params_and_accumulator_match_jax(engine):
    jp, tp = _both(SHAPE_SETS[0], jnp.bfloat16, torch.bfloat16)
    je = jmake(engine, jp, SEED, acc_dtype="bfloat16")
    te = make_engine(engine, tp, SEED, acc_dtype="bfloat16")
    scale = 1e-2 * float(je.inv_norm(jnp.int32(T), jnp.uint32(1)))
    jout = jax.jit(lambda p: je.perturb(p, jnp.int32(T), jnp.uint32(1), jnp.float32(scale)))(jp)
    tout = te.perturb(tp, T, 1, torch.tensor(scale))
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
        assert a.dtype == torch.bfloat16
        _close(a.float(), b, rtol=1e-2, atol=1e-2)
    cs = np.asarray([0.5, -1.0, 2.0, 0.1], np.float32)
    jrec = jax.jit(lambda: je.reconstruct(jnp.asarray(cs), jnp.int32(T)))()
    trec = te.reconstruct(torch.from_numpy(cs), T)
    for a, b in zip(tree_leaves(trec), jax.tree.leaves(jrec)):
        _close(a, b, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("shapes", SHAPE_SETS)
@pytest.mark.parametrize("block", [64, 4096])
def test_flat_layout_matches_jax(shapes, block):
    jp, tp = _both(shapes)
    je = jmake("flat", jp, SEED, block=block)
    te = make_engine("flat", tp, SEED, block=block)
    assert (te.n_blocks, te.padded_dim, te.pad_offsets) == \
        (je.n_blocks, je.padded_dim, je.pad_offsets)
    np.testing.assert_array_equal(te._blk_ctr.to(torch.int64).numpy(), np.asarray(je._blk_ctr))
    np.testing.assert_array_equal(te._blk_nv.numpy(), np.asarray(je._blk_nv))
    np.testing.assert_array_equal(te._blk_bf16.numpy(), np.asarray(je._blk_bf16))
    np.testing.assert_array_equal(te.blk_salts_multi(T, range(3)).to(torch.int64).numpy(),
                                  np.asarray(je.blk_salts_multi(jnp.int32(T),
                                                                jnp.arange(3, dtype=jnp.uint32))))
    np.testing.assert_array_equal(te.pack(tp).numpy(), np.asarray(je.pack(jp)))


def test_flat_pack_unpack_roundtrip():
    """pack/unpack is lossless through the block-padded fp32 buffer,
    including scalar leaves and bf16 leaves (cf. test_engine.py:336)."""
    params = {
        "w": torch.randn(37, 3, generator=torch.Generator().manual_seed(0)),
        "b": torch.linspace(-1.0, 1.0, 129).to(torch.bfloat16),
        "s": torch.tensor(0.25),
    }
    eng = make_engine("flat", params, SEED)
    buf = eng.pack(params)
    assert buf.dtype == torch.float32 and buf.shape == (eng.padded_dim,)
    assert eng.padded_dim % eng.block == 0
    out = eng.unpack(buf)
    assert list(out) == sorted(params)
    for k in params:
        assert out[k].dtype == params[k].dtype and out[k].shape == params[k].shape
        assert torch.equal(out[k].float(), params[k].float())
    for x in tree_leaves(eng.unpack(buf, cast=False)):
        assert x.dtype == torch.float32
    assert eng.pack(params).data_ptr() != buf.data_ptr()   # a fresh copy each call


def _quad_loss(p, b):
    return 0.5 * torch.mean(torch.sum((p["x"] - b["t"]) ** 2, -1))


def _jquad_loss(p, b):
    return 0.5 * jnp.mean(jnp.sum((p["x"] - b["t"]) ** 2, -1))


def _quad_batches(m, B, d, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield {"t": (1.0 + 0.1 * rng.normal(size=(m * B, d))).astype(np.float32)}


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_flat_fused_step_loss_equivalent_to_fused_and_jax(momentum):
    """cf. test_engine.py:360: the port's flat fused step against its fused
    engine, and against the JAX flat engine on the same problem."""
    m, B, d = 4, 4, 63
    hists = {}
    for name in ("fused", "flat"):
        cfg = HOSGDConfig(tau=1 << 30, mu=1e-3, m=m, lr=0.1, zo_lr=0.1 / d,
                          engine=name, momentum=momentum)
        hists[name] = run_method(make_ho_sgd(_quad_loss, cfg), {"x": torch.zeros(d)},
                                 _quad_batches(m, B, d), 12)
    jcfg = JCfg(tau=1 << 30, mu=1e-3, m=m, lr=0.1, zo_lr=0.1 / d, engine="flat",
                momentum=momentum)
    jh = jrun(jmake_ho(_jquad_loss, jcfg), {"x": jnp.zeros((d,))}, _quad_batches(m, B, d), 12)
    np.testing.assert_allclose(hists["flat"]["loss"], hists["fused"]["loss"], rtol=1e-4)
    # across frameworks the two losses of each coefficient differ by ulps of
    # their reductions, and c = (d/mu)(f1 - f0) scales that by d/mu = 6.3e4
    # at every step (compounded by momentum): 5e-4 on this toy problem
    np.testing.assert_allclose(hists["flat"]["loss"], jh["loss"], rtol=5e-4)
    for other in (hists["fused"]["params"]["x"].numpy(), np.asarray(jh["params"]["x"])):
        np.testing.assert_allclose(hists["flat"]["params"]["x"].numpy(), other,
                                   rtol=5e-3, atol=1e-5)


def test_flat_fused_step_does_not_touch_caller_buffers():
    """cf. test_engine.py:382: the commit writes in place into the engine's
    packed copy, never into the caller's params or optimizer state."""
    m, B, d = 2, 2, 37
    p0 = {"x": torch.linspace(-1.0, 1.0, d)}
    keep = p0["x"].clone()
    cfg = HOSGDConfig(tau=1 << 30, mu=1e-3, m=m, lr=0.1, zo_lr=0.1 / d,
                      engine="flat", momentum=0.9)
    meth = make_ho_sgd(_quad_loss, cfg)
    state = meth.init(p0)
    batch = next(_quad_batches(m, B, d))
    p1, s1, met1 = meth.step(1, p0, state, batch)
    assert torch.equal(p0["x"], keep) and torch.all(state["x"] == 0)
    p2, s2, met2 = meth.step(1, p0, state, batch)
    assert torch.equal(p1["x"], p2["x"]) and torch.equal(s1["x"], s2["x"])
    assert float(met1["loss"]) == float(met2["loss"])
    # a further step from p1 leaves p1 itself intact
    keep1 = p1["x"].clone()
    meth.step(2, p1, s1, batch)
    assert torch.equal(p1["x"], keep1)


def test_flat_fused_step_bf16_params():
    """cf. test_engine.py:401: bf16 leaves round-trip the fp32 buffer and are
    rounded back to bf16 inside the commit (the bf16-mask path)."""
    m, B, d = 2, 2, 37

    def loss_fn(p, b):
        x = p["x"].float()
        return 0.5 * torch.mean(torch.sum((x - b["t"]) ** 2, -1)) + 0.5 * p["s"] ** 2

    p0 = {"x": torch.zeros(d, dtype=torch.bfloat16), "s": torch.tensor(1.0)}
    hists = {}
    for name in ("fused", "flat"):
        cfg = HOSGDConfig(tau=1 << 30, mu=1e-2, m=m, lr=0.1, zo_lr=0.1 / d,
                          engine=name, momentum=0.9)
        hists[name] = run_method(make_ho_sgd(loss_fn, cfg), p0, _quad_batches(m, B, d), 5)
    assert hists["flat"]["params"]["x"].dtype == torch.bfloat16
    assert hists["flat"]["params"]["s"].dtype == torch.float32
    np.testing.assert_allclose(hists["flat"]["params"]["x"].float().numpy(),
                               hists["fused"]["params"]["x"].float().numpy(),
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(hists["flat"]["loss"], hists["fused"]["loss"], rtol=1e-3)


def test_flat_nonsgd_optimizer_takes_generic_path(monkeypatch):
    """cf. test_engine.py:429: adam on flat runs reconstruct-then-opt.update
    (never the fused commit) and agrees with the tree engine and with JAX."""
    from repro.opt.optimizers import adam as jadam, const_schedule as jconst
    from repro_torch.opt.optimizers import adam, const_schedule

    def no_fused(*a, **k):
        raise AssertionError("the fused path ran for a non-SGD optimizer")

    monkeypatch.setattr(FlatEngine, "fused_perturb_sumsq", no_fused)
    monkeypatch.setattr(FlatEngine, "fused_reconstruct_update", no_fused)
    m, B, d = 2, 2, 63
    hists = {}
    for name in ("tree", "flat"):
        cfg = HOSGDConfig(tau=1 << 30, mu=1e-3, m=m, lr=0.05, zo_lr=0.05 / d,
                          engine=name, acc_dtype="bfloat16")
        meth = make_ho_sgd(_quad_loss, cfg, opt=adam(const_schedule(0.05)))
        hists[name] = run_method(meth, {"x": torch.zeros(d)}, _quad_batches(m, B, d), 5)
    jcfg = JCfg(tau=1 << 30, mu=1e-3, m=m, lr=0.05, zo_lr=0.05 / d, engine="tree",
                acc_dtype="bfloat16")
    jh = jrun(jmake_ho(_jquad_loss, jcfg, opt=jadam(jconst(0.05))), {"x": jnp.zeros((d,))},
              _quad_batches(m, B, d), 5)
    for h in (hists["flat"], jh):
        np.testing.assert_allclose(h["loss"], hists["tree"]["loss"], rtol=1e-4)
        np.testing.assert_allclose(np.asarray(h["params"]["x"]),
                                   hists["tree"]["params"]["x"].numpy(), rtol=1e-2, atol=1e-4)


def test_tree_and_fused_engines_bitwise_in_torch():
    """Same leaf shapes, same op sequence: the two plain engines give the
    identical ZO trajectory (bf16 accumulator, as test_engine.py:194)."""
    m, B, d = 4, 4, 63
    hists = {}
    for name in ("tree", "fused"):
        cfg = HOSGDConfig(tau=1 << 30, mu=1e-3, m=m, lr=0.1, zo_lr=0.1 / d,
                          engine=name, acc_dtype="bfloat16")
        hists[name] = run_method(make_ho_sgd(_quad_loss, cfg), {"x": torch.zeros(d)},
                                 _quad_batches(m, B, d), 5)
    assert torch.equal(hists["tree"]["params"]["x"], hists["fused"]["params"]["x"])
    assert hists["tree"]["loss"] == hists["fused"]["loss"]


def test_make_engine_errors():
    """Every name of the reference builds its engine (``pallas`` too, since
    the per-leaf kernels are ported); an unknown name and sharding specs
    raise."""
    p = {"x": torch.zeros(3)}
    assert isinstance(make_engine("pallas", p, 0), PallasEngine)
    assert sorted(ENGINES) == ["flat", "fused", "pallas", "tree"]
    with pytest.raises(ValueError, match="unknown direction engine"):
        make_engine("mosaic", p, 0)
    with pytest.raises(ValueError, match="specs"):
        make_engine("tree", p, 0, specs=[None])
