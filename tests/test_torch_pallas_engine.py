"""The per-leaf kernels and the ``pallas`` engine of the port against the JAX
package, on the CPU.

* ``kernels.ops.zo_sumsq``/``zo_perturb``/``zo_reconstruct`` (their plain
  versions on CPU tensors) against ``repro.kernels.ops`` (the Pallas kernels
  in interpret mode) at ``tests/test_kernels.py::test_zo_kernels_sweep``'s
  ``(n, block)`` cases, reconstruct also at m = 1, 2 and 5 and at an offset
  whose counters wrap past 2^32: sumsq rtol 1e-5, perturb and reconstruct
  rtol 1e-5 / atol 1e-6 (the Gaussians differ by ulps of log/cos between
  the two math libraries), the bf16 accumulator bitwise (its rounding after
  every worker quantizes those ulps away at these inputs);
* the run-table plain versions (a shard of a leaf: runs of consecutive
  global counters, one kernel call) bit for bit the contiguous ones called
  run by run, across 2^32 and at run lengths no multiple of a vector;
* ``PallasEngine`` against the JAX ``PallasEngine`` on the Fig. 2 MLP at
  hidden=16 (salts bitwise, Gaussians rtol 1e-5 / atol 1e-6) and against the
  port's own ``tree`` engine bitwise (the same float32 expressions);
* ``vmap_workers`` against the sequential path (one float32 contraction
  against per-worker accumulation: rtol 1e-5 / atol 1e-6; with a bf16
  accumulator one final rounding of that contraction, bitwise, within four
  half-ulp roundings of the sequential path's partial sums);
* HO-SGD with ``engine="pallas"`` against JAX's (losses rtol 1e-4, as the
  Fig. 2 slice test) and against the port's ``tree`` engine, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zo_grad as JZ
from repro.core.engine import make_engine as jmake
from repro.core.ho_sgd import HOSGDConfig as JCfg, make_ho_sgd as jmake_ho, run_method as jrun
from repro.kernels import ops as jops
from repro.models.mlp import init_mlp_classifier as jinit, mlp_loss as jmlp_loss
from repro_torch.convert import params_from_numpy
from repro_torch.core import zo_grad as TZ
from repro_torch.core.engine import PallasEngine, make_engine
from repro_torch.core.ho_sgd import HOSGDConfig, make_ho_sgd, run_method
from repro_torch.data.synthetic import batches, make_classification
from repro_torch.kernels import fake, ops
from repro_torch.kernels import zo_direction as cu
from repro_torch.models.mlp import mlp_loss
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

FP32_TOL = dict(rtol=1e-5, atol=1e-6)
SWEEP = [(4096, 1024), (8192, 4096), (2048, 2048), (5000, 4096), (1000, 512),
         (37, 8), (3, 4096), (1, 4096)]
SALTS = np.asarray([1, 2, 3, 4], np.uint32)
COEFFS = np.asarray([0.5, -1.0, 2.0, 0.1], np.float32)
#: zo_reconstruct's cases beside m = 4 at a test's own offset: m = 1, 2 and 5
#: workers (the first m of five salts and coefficients), at that offset and
#: at 2^32 - 2, where the counters wrap at lane 2 (``wraps``)
WRAP = 2 ** 32 - 2
M_WRAPS = [(m, wraps) for m in (1, 2, 5) for wraps in (False, True)] + [(4, True)]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _workers(m, salts=(1, 2, 3, 4, 5), coeffs=(0.5, -1.0, 2.0, 0.1, -0.7)):
    return np.asarray(salts[:m], np.uint32), np.asarray(coeffs[:m], np.float32)


@pytest.mark.parametrize("n,block,m,offset",
                         [pytest.param(n, block, 4, 9, id=f"{n}-{block}") for n, block in SWEEP]
                         + [pytest.param(n, block, m, WRAP if wraps else 9,
                                         id=f"{n}-{block}-m{m}" + "-wraps" * wraps)
                            for n, block in ((5000, 4096), (37, 8)) for m, wraps in M_WRAPS])
def test_per_leaf_ops_match_jax_kernels(n, block, m, offset):
    ss = ops.zo_sumsq(n, 1234, offset=77, device="cpu")
    assert ss.dtype == torch.float32 and ss.dim() == 0
    np.testing.assert_allclose(float(ss), float(jops.zo_sumsq(n, 1234, offset=77, block=block)),
                               rtol=1e-5)
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    out = ops.zo_perturb(torch.from_numpy(x), 55, 0.01, offset=3)
    want = jops.zo_perturb(jnp.asarray(x), 55, 0.01, offset=3, block=block)
    np.testing.assert_allclose(_np(out), np.asarray(want), **FP32_TOL)
    salts, coeffs = _workers(m)
    out = ops.zo_reconstruct(n, torch.from_numpy(salts), torch.from_numpy(coeffs), offset=offset)
    want = jops.zo_reconstruct(n, jnp.asarray(salts), jnp.asarray(coeffs),
                               offset=np.uint32(offset), block=block)
    assert out.dtype == torch.float32 and out.shape == (n,)
    np.testing.assert_allclose(_np(out), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("n,block,m,offset",
                         [pytest.param(n, block, 4, 0, id=f"{n}-{block}")
                          for n, block in ((1000, 512), (2048, 2048))]
                         + [pytest.param(1000, 512, m, WRAP if wraps else 0,
                                         id=f"1000-512-m{m}" + "-wraps" * wraps)
                            for m, wraps in M_WRAPS])
def test_per_leaf_bf16_paths_match_jax_kernels(n, block, m, offset):
    """bf16 leaves through zo_perturb and the bf16 accumulator of
    zo_reconstruct (cf. test_kernels.py::test_zo_reconstruct_acc_dtype)."""
    salts, coeffs = _workers(m, (7, 11, 13, 17, 19), (0.25, -0.75, 1.5, 0.3, -1.25))
    out = ops.zo_reconstruct(n, torch.from_numpy(salts), torch.from_numpy(coeffs), offset,
                             acc_dtype="bfloat16")
    want = jops.zo_reconstruct(n, jnp.asarray(salts), jnp.asarray(coeffs),
                               offset=np.uint32(offset), block=block, acc_dtype="bfloat16")
    np.testing.assert_array_equal(_np(out), np.asarray(want))
    x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.zo_perturb(xt, 9, 0.5, offset=5)
    assert got.dtype == torch.bfloat16
    want = jops.zo_perturb(jnp.asarray(x).astype(jnp.bfloat16), 9, 0.5, offset=5, block=block)
    # one bf16 ulp where an ulp of log/cos lands on a rounding boundary
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=2 ** -8, atol=0)


def test_split_leaf_calls_equal_one_call():
    """Two calls at offsets 0 and k equal one call over the whole leaf."""
    n, k = 5000, 1234
    x = torch.randn(n, generator=torch.Generator().manual_seed(0))
    whole = ops.zo_perturb(x, 77, 0.3)
    assert torch.equal(torch.cat([ops.zo_perturb(x[:k], 77, 0.3),
                                  ops.zo_perturb(x[k:], 77, 0.3, offset=k)]), whole)
    s, c = torch.from_numpy(SALTS), torch.from_numpy(COEFFS)
    assert torch.equal(torch.cat([ops.zo_reconstruct(k, s, c),
                                  ops.zo_reconstruct(n - k, s, c, offset=k)]),
                       ops.zo_reconstruct(n, s, c))
    parts = ops.zo_sumsq(k, 77, device="cpu") + ops.zo_sumsq(n - k, 77, k, device="cpu")
    assert float(parts) == pytest.approx(float(ops.zo_sumsq(n, 77, device="cpu")), rel=1e-6)


#: (runs, run length, first start, start step): runs of 1024 (a column-
#: parallel shard's rows), lengths no multiple of 4 or 8 (1027, 3, 1), and
#: starts across 2^32 (run 20 wraps inside itself)
RUN_TABLES = [(40, 1024, 0, 2048), (9, 1027, 7, 4099), (101, 3, 5, 8), (17, 1, 11, 3),
              (40, 1024, 2 ** 32 - 20 * 1024 - 500, 1024)]


def _starts(runs, first, step):
    return ((first + step * torch.arange(runs, dtype=torch.int64)) % 2 ** 32).to(torch.uint32)


@pytest.mark.parametrize("runs,run,first,step", RUN_TABLES)
def test_run_table_plain_versions_are_the_contiguous_ones_run_by_run(runs, run, first, step):
    """``zo_perturb`` and ``zo_reconstruct`` on a run table (their plain
    versions, as ``kernels.ops`` runs them on the CPU) bit for bit the
    contiguous plain versions called once per run at its start; the shard
    taken for a leaf of its own (local counters) differs (the control)."""
    n = runs * run
    starts = _starts(runs, first, step)
    g = torch.Generator().manual_seed(runs)
    for x in (torch.randn(n, generator=g), torch.randn(n, generator=g).to(torch.bfloat16)):
        got = ops.zo_perturb(x, 77, 0.3, starts=starts)
        assert got.dtype == x.dtype
        assert torch.equal(got, torch.cat([ops.zo_perturb(x[r * run:(r + 1) * run], 77, 0.3,
                                                          offset=int(starts[r]))
                                           for r in range(runs)]))
        assert not torch.equal(got, ops.zo_perturb(x, 77, 0.3))
    s, c = torch.from_numpy(SALTS), torch.from_numpy(COEFFS)
    for acc in ("float32", "bfloat16"):
        got = ops.zo_reconstruct(n, s, c, acc_dtype=acc, starts=starts)
        assert torch.equal(got, torch.cat([ops.zo_reconstruct(run, s, c, int(starts[r]), acc)
                                           for r in range(runs)]))
        assert not torch.equal(got, ops.zo_reconstruct(n, s, c, acc_dtype=acc))


def test_run_tables_are_checked_and_fake_operators_take_them():
    """A table that does not cut the leaf into equal runs, or one beside a
    nonzero offset, raises on every path; a leaf without data takes the
    operator with its table (one call)."""
    starts = _starts(3, 0, 16)
    for call in (lambda: ops.zo_perturb(torch.zeros(10), 1, 0.1, starts=starts),
                 lambda: ops.zo_perturb(torch.zeros(12), 1, 0.1, offset=5, starts=starts),
                 lambda: ops.zo_reconstruct(10, torch.from_numpy(SALTS),
                                            torch.from_numpy(COEFFS), starts=starts),
                 lambda: ops.zo_perturb(torch.zeros(10, device="meta"), 1, 0.1,
                                        starts=starts.to("meta"))):
        with pytest.raises(ValueError, match="starts"):
            call()
    fake.reset_calls()
    out = ops.zo_perturb(torch.zeros(12, device="meta"), 1, 0.1, starts=starts.to("meta"))
    rec = ops.zo_reconstruct(12, torch.zeros(4, dtype=torch.uint32, device="meta"),
                             torch.zeros(4, device="meta"), starts=starts.to("meta"))
    assert out.shape == rec.shape == (12,) and rec.dtype == torch.float32
    assert fake.CALLS["zo_perturb"] == fake.CALLS["zo_reconstruct"] == 1


@pytest.mark.parametrize("n,block,offset", [(5000, 4096, 2 ** 32 - 1000),
                                            (3000, 1024, 2 ** 32 - 1)])
def test_zo_sumsq_matches_jax_where_the_counter_wraps(n, block, offset):
    """ops.zo_sumsq (its plain version here) against the JAX zo_sumsq at an
    offset whose counters offset + i wrap past 2^32 inside the leaf (rtol
    1e-5, the Gaussians' ulps), and the wrapped leaf as its two parts on
    either side of the wrap (rtol 1e-6)."""
    ss = ops.zo_sumsq(n, 1234, offset, device="cpu")
    want = jops.zo_sumsq(n, 1234, offset=np.uint32(offset), block=block)   # past int32
    np.testing.assert_allclose(float(ss), float(want), rtol=1e-5)
    k = 2 ** 32 - offset                   # lanes before the counter wraps to 0
    parts = ops.zo_sumsq(k, 1234, offset, device="cpu") + ops.zo_sumsq(n - k, 1234, 0,
                                                                       device="cpu")
    assert float(parts) == pytest.approx(float(ss), rel=1e-6)


def test_cpu_path_launches_nothing_and_the_kernels_take_cuda_tensors():
    before = dict(cu.LAUNCHES)
    ops.zo_perturb(torch.zeros(8), 1, 0.1)
    ops.zo_reconstruct(8, torch.from_numpy(SALTS), torch.from_numpy(COEFFS))
    ops.zo_sumsq(8, 1, device="cpu")
    assert cu.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        cu.zo_perturb(torch.zeros(8), 1, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        cu.zo_reconstruct(8, torch.from_numpy(SALTS), torch.from_numpy(COEFFS))
    with pytest.raises(ValueError, match="CUDA"):
        cu.zo_sumsq(8, 1, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.zo_sumsq(8, 1, device="xpu")
    # a tensor without data (the dry run's meta device) takes the kernel's
    # operator (kernels.fake): no launch, the plain version's shape
    fake.reset_calls()
    assert ops.zo_sumsq(8, 1, device="meta").device.type == "meta"
    assert ops.zo_perturb(torch.zeros(8, device="meta"), 1, 0.1).shape == (8,)
    assert fake.CALLS["zo_sumsq"] == fake.CALLS["zo_perturb"] == 1
    assert cu.LAUNCHES == before


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mlp():
    p0 = {k: np.asarray(v) for k, v in jinit(jax.random.key(0), 54, 7, hidden=16).items()}
    return p0, {k: jnp.asarray(v) for k, v in p0.items()}, params_from_numpy(p0, device="cpu")


@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_pallas_engine_matches_jax_pallas_engine(mlp, acc_dtype):
    _, jp, tp = mlp
    je = jmake("pallas", jp, 3, block=64, acc_dtype=acc_dtype)
    te = make_engine("pallas", tp, 3, acc_dtype=acc_dtype)
    assert isinstance(te, PallasEngine) and te.sizes == je.sizes
    for w in range(4):
        assert te.salts(5, w) == [int(s) for s in je.salts(jnp.int32(5), jnp.uint32(w))]
    jinv = float(jax.jit(je.inv_norm)(jnp.int32(5), jnp.uint32(1)))
    assert float(te.inv_norm(5, 1)) == pytest.approx(jinv, rel=1e-6)
    scale = 0.3 * jinv
    jout = jax.jit(lambda p: je.perturb(p, jnp.int32(5), jnp.uint32(1), jnp.float32(scale)))(jp)
    tout = te.perturb(tp, 5, 1, torch.tensor(scale, dtype=torch.float32))
    for a, b, x in zip(tree_leaves(tout), jax.tree.leaves(jout), tree_leaves(tp)):
        # the perturbation itself, not the values it is added to
        np.testing.assert_allclose(_np(a - x), np.asarray(b) - _np(x), rtol=1e-5, atol=1e-6)
    cs = np.asarray([0.5, -1.0, 2.0, 0.1], np.float32)
    jrec = jax.jit(lambda: je.reconstruct(jnp.asarray(cs), jnp.int32(5)))()
    trec = te.reconstruct(torch.from_numpy(cs), 5)
    for a, b in zip(tree_leaves(trec), jax.tree.leaves(jrec)):
        assert a.dtype == torch.float32
        if acc_dtype == "float32":
            np.testing.assert_allclose(_np(a), np.asarray(b), **FP32_TOL)
        else:   # bf16 roundings of values that differ by f32 ulps: one bf16 ulp
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2 ** -8, atol=1e-30)


@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_pallas_engine_bitwise_equals_tree_engine(mlp, acc_dtype):
    _, _, tp = mlp
    tp = dict(tp, b1=tp["b1"].to(torch.bfloat16))            # one bf16 leaf
    pe = make_engine("pallas", tp, 3, acc_dtype=acc_dtype)
    te = make_engine("tree", tp, 3, acc_dtype=acc_dtype)
    scale = 1e-2 * te.inv_norm(4, 2)
    for a, b in zip(tree_leaves(pe.perturb(tp, 4, 2, scale)),
                    tree_leaves(te.perturb(tp, 4, 2, scale))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    cs = torch.tensor([0.5, -1.0, 2.0, 0.1])
    for workers in (None, [0, 2]):
        c = cs if workers is None else cs[:2]
        for a, b in zip(tree_leaves(pe.reconstruct(c, 4, workers)),
                        tree_leaves(te.reconstruct(c, 4, workers))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ["tree", "fused", "pallas", "flat"])
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_vmap_workers_matches_sequential(mlp, engine, acc_dtype):
    _, _, tp = mlp
    eng = make_engine(engine, tp, 3, acc_dtype=acc_dtype)
    eng32 = make_engine(engine, tp, 3)
    cs = torch.tensor([0.5, -1.0, 2.0, 0.1])
    seq = eng.reconstruct(cs, 6)
    vm = eng.reconstruct(cs, 6, vmap_workers=True)
    vm32 = eng32.reconstruct(cs, 6, vmap_workers=True)
    for a, b, c in zip(tree_leaves(vm), tree_leaves(seq), tree_leaves(vm32)):
        if acc_dtype == "float32":
            np.testing.assert_allclose(_np(a), _np(b), **FP32_TOL)
        else:
            # one final rounding of the float32 contraction ...
            assert torch.equal(a, c.to(torch.bfloat16).float())
            # ... against four roundings of the partial sums, each within
            # half a bf16 ulp (2**-9 relative) of a partial sum
            atol = 4 * 2 ** -9 * 2 * float(c.abs().max())
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)
    batch = {"x": torch.randn(4, 8, 54, generator=torch.Generator().manual_seed(1)),
             "y": torch.randint(0, 7, (4, 8), generator=torch.Generator().manual_seed(2))}
    c1, f1 = eng.zo_coeffs(mlp_loss, tp, batch, 6, [0, 1, 2, 3], 1e-3)
    c2, f2 = eng.zo_coeffs(mlp_loss, tp, batch, 6, [0, 1, 2, 3], 1e-3, vmap_workers=True)
    assert torch.equal(c1, c2) and torch.equal(f1, f2)


def test_reconstruct_update_vmap_workers_matches_jax(mlp):
    _, jp, tp = mlp
    cs = np.asarray([0.5, -1.0, 2.0], np.float32)
    for vmap_workers in (False, True):
        got = TZ.reconstruct_update(tp, torch.from_numpy(cs), 3, 5, engine="pallas",
                                    vmap_workers=vmap_workers)
        want = JZ.reconstruct_update(jp, jnp.asarray(cs), 3, jnp.int32(5), engine="tree",
                                     vmap_workers=vmap_workers)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(a), np.asarray(b), **FP32_TOL)


def test_ho_sgd_pallas_engine_matches_jax_and_tree(mlp):
    p0, _, tp = mlp
    ds = make_classification("covtype", n_train=512)
    d = sum(v.size for v in p0.values())
    kw = dict(tau=4, mu=1e-3, m=4, lr=0.05, zo_lr=0.05 * 30.0 / d)
    jh = jrun(jmake_ho(jmlp_loss, JCfg(**kw, engine="fused")), p0,
              batches(ds, 64, seed=1), 8)
    th = {e: run_method(make_ho_sgd(mlp_loss, HOSGDConfig(**kw, engine=e)), tp,
                        batches(ds, 64, seed=1), 8) for e in ("pallas", "tree")}
    assert th["pallas"]["order"] == jh["order"] == [1, 0, 0, 0, 1, 0, 0, 0]
    np.testing.assert_allclose(th["pallas"]["loss"], jh["loss"], rtol=1e-4)
    assert th["pallas"]["loss"] == th["tree"]["loss"]
    for k in tp:
        assert torch.equal(th["pallas"]["params"][k], th["tree"]["params"][k])
