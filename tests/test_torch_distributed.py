"""The port's distributed HO-SGD (``core.distributed``) on the CPU.

* One process holding m=4 workers (a one-rank gloo group, the reference's
  1x1 mesh with ``m=4``): FO and ZO steps of ``make_distributed_ho_sgd``
  for the tree, flat and pallas engines, bit for bit equal to the port's
  ``make_ho_sgd`` (the same calls in the same order; flat runs the fused
  round on both sides), and on ZO rounds to its ``RoundExecutor`` (tree and
  pallas: the same per-worker calls); against the reference's lowered
  steps (tests/test_rounds_equivalence.py:95-160 pins them to the
  pre-IR monolithic step) round by round from the reference's parameters:
  losses to rtol 1e-5, FO parameters to rtol 1e-6 / atol 1e-7, ZO
  parameters to 2% of the update.  On this jax the reference lowers its ZO
  step through ``shard_map``, which on one device evaluates worker 0 only;
  the tests switch ``repro.compat.HAS_PARTIAL_AUTO_COLLECTIVES`` off, so the
  reference runs its own auto-sharded branch, the formulation this path
  ports.
* The ledger (tests/test_comm_ledger.py:138-224): 4·d per FO step and 4·m
  per ZO step, one scalar under fsdp, QSGD below dense, per-worker codec
  bytes m x nbytes against legacy's nbytes (m in {1, 4}, equal to the
  reference's), buckets {1, 2, 5, 8} with bit-identical parameters and
  equal bytes; the worker count is ``HOSGDConfig.m`` (a group of another
  size is refused).
* One group of 4 gloo ranks, spawned once for the module (a ``file://``
  store in ``tmp_path``, every rank joined with a timeout): each rank gets
  its own rows from ``data.pipeline.shard_batches``; the rank-per-worker
  steps (tree, flat, pallas; flat on a 2x2 pod x data mesh, worker id
  ``pod_idx * n_data + data_idx``; QSGD per worker and legacy) give every
  rank the same parameters, losses within rtol 1e-6 of the one-process run
  (1e-3 with legacy QSGD, which rounds a mean the ranks sum in another
  order) and parameters within 2% of the update, and rank 0's ledger books 4·m per
  ZO step and 4·d per FO step (the codecs' bytes like the one-process run);
  ``all_gather`` stacks in worker order.
"""
import os
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_helpers as H
from repro import compat
from repro.core import distributed as JD
from repro.core.ho_sgd import HOSGDConfig as JCfg
from repro.dist import CommLedger as JLedger
from repro.dist.compress import qsgd as jqsgd
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.opt.optimizers import const_schedule as jconst, sgd as jsgd
from repro_torch.core import distributed as TD
from repro_torch.core import rounds as R
from repro_torch.core.ho_sgd import make_ho_sgd
from repro_torch.dist import CommLedger
from repro_torch.dist.compress import qsgd
from repro_torch.launch.mesh import init_rank, make_test_mesh, spawn_ranks
from repro_torch.opt.optimizers import const_schedule, sgd

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

DIM, M, STEPS = 96, 4, 6
quad_loss = H.quad_loss


def jquad_loss(params, batch):
    return 0.5 * jnp.mean(jnp.sum((params["x"] - batch["t"]) ** 2, -1))


def data(steps=STEPS):
    rng = np.random.default_rng(0)
    return [{"t": rng.normal(size=(2 * M, DIM)).astype(np.float32)} for _ in range(steps)]


def x0():
    return {"x": torch.linspace(-1.0, 1.0, DIM)}


def assert_update_close(got, want, start, what=""):
    """|got - want| <= 2% of the largest update (+1e-7)."""
    got, want, start = (np.asarray(a, np.float32) for a in (got, want, start))
    scale = max(float(np.abs(want - start).max()), 1e-12)
    diff = float(np.abs(got - want).max())
    assert diff <= 0.02 * scale + 1e-7, (what, diff, scale)


@pytest.fixture(autouse=True)
def reference_auto_branch(monkeypatch):
    """The reference lowers through its auto-sharded branch (module docstring)."""
    monkeypatch.setattr(compat, "HAS_PARTIAL_AUTO_COLLECTIVES", False)


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group and its 1x1 mesh (the reference's
    ``make_test_mesh(data=1, model=1)``)."""
    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, 1, os.path.join(tmp, "init"))
        try:
            yield make_test_mesh(data=1, model=1, device="cpu")
        finally:
            dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# one process holding m workers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", ["tree", "flat", "pallas"])
def test_one_process_steps_bitwise_equal_make_ho_sgd_and_executor(mesh, engine):
    ho = H.ho_config(engine)
    fo, zo = TD.make_distributed_ho_sgd(quad_loss, mesh, ho)
    ref = make_ho_sgd(quad_loss, ho)
    ex = R.RoundExecutor(R.ho_sgd_program(quad_loss, ho))
    p, s, pr, sr = x0(), (), x0(), ref.init(x0())
    for t, b in enumerate(data()):
        before = p
        p, s, loss = (fo if t % H.TAU == 0 else zo)(t, p, s, b)
        pr, sr, met = ref.step(t, pr, sr, b)
        assert torch.equal(p["x"], pr["x"]) and float(loss) == float(met["loss"]), t
        pe, _, me = ex.run(t, before, {"opt": (), "since_fo": 0}, b)
        if t % H.TAU == 0:
            np.testing.assert_allclose(pe["x"].numpy(), p["x"].numpy(), rtol=1e-6, atol=1e-7)
        elif engine != "flat":          # flat: the fused round sums v^2 in another order
            assert torch.equal(pe["x"], p["x"]) and float(me["loss"]) == float(loss), t


@pytest.mark.parametrize("engine", ["tree", "flat", "pallas"])
def test_one_process_steps_match_reference_lowering(mesh, engine):
    jmesh = jmake_test_mesh(data=1, model=1)
    kw = dict(tau=H.TAU, mu=1e-3, m=M, lr=0.1, zo_lr=0.05, engine=engine)
    jopt = jsgd(jconst(0.1))
    jfo, jzo = jax.jit(JD.make_fo_step(jquad_loss, jmesh, jopt)), \
        jax.jit(JD.make_zo_step(jquad_loss, jmesh, JCfg(**kw), jopt, m=M))
    fo, zo = TD.make_distributed_ho_sgd(quad_loss, mesh, H.ho_config(engine))
    jp = {"x": jnp.linspace(-1.0, 1.0, DIM, dtype=jnp.float32)}
    for t, b in enumerate(data()):
        # each step from the reference's params, so drift does not compound
        p = {"x": torch.from_numpy(np.asarray(jp["x"]).copy())}
        p, _, loss = (fo if t % H.TAU == 0 else zo)(t, p, (), b)
        jp2, _, jloss = (jfo if t % H.TAU == 0 else jzo)(jnp.int32(t), jp, (), jax.tree.map(
            jnp.asarray, b))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5), t
        if t % H.TAU == 0:
            np.testing.assert_allclose(p["x"].numpy(), np.asarray(jp2["x"]), rtol=1e-6, atol=1e-7)
        else:
            assert_update_close(p["x"].numpy(), jp2["x"], jp["x"], t)
        jp = jp2


class _Shape:
    """A mesh as its axis sizes only."""

    def __init__(self, **axes):
        self.shape = axes


@pytest.mark.parametrize("m", [2, 4])
def test_one_rank_mesh_takes_m_from_the_config(mesh, m):
    """The one process holds ``ho.m`` workers: ZO books 4·m bytes and steps
    as ``make_ho_sgd`` at that m does."""
    ho = H.ho_config("tree", m=m)
    fo, zo = TD.make_distributed_ho_sgd(quad_loss, mesh, ho)
    ref = make_ho_sgd(quad_loss, ho)
    led = CommLedger()
    zo = led.wrap("zo", zo)
    b = {"t": data(1)[0]["t"][:2 * m]}
    p, _, loss = zo(1, x0(), (), b)
    rp, _, met = ref.step(1, x0(), ref.init(x0()), b)
    assert led.bytes_per_step("zo") == 4 * m
    assert torch.equal(p["x"], rp["x"]) and float(loss) == float(met["loss"])


def test_a_group_of_another_worker_count_is_refused():
    with pytest.raises(ValueError, match="one worker per rank"):
        TD.make_distributed_ho_sgd(quad_loss, _Shape(data=4, model=1), H.ho_config("tree", m=2))


# --------------------------------------------------------------------------- #
# the ledger
# --------------------------------------------------------------------------- #
def _one_step_bytes(mesh, which, m=1, d=64, **kw):
    """Bytes one wrapped FO (t=0) or ZO (t=1) step books, both packages."""
    out, rows = [], 2 * (m or 2)
    for make, led, params, batch, opt in (
            (TD, CommLedger(), {"x": torch.zeros(d)}, {"t": torch.ones(rows, d)},
             sgd(const_schedule(0.05))),
            (JD, JLedger(), {"x": jnp.zeros((d,))}, {"t": jnp.ones((rows, d))},
             jsgd(jconst(0.05)))):
        msh = mesh if make is TD else jmake_test_mesh(data=1, model=1)
        codec = kw.get("compressor")
        kw2 = dict(kw, compressor=None if codec is None else
                   (qsgd(codec) if make is TD else jqsgd(codec)))
        if which == "fo":
            step = make.make_fo_step(quad_loss if make is TD else jquad_loss, msh, opt, m=m, **kw2)
        else:
            cfg = (H.HOSGDConfig if make is TD else JCfg)(tau=4, mu=1e-3, m=m or 1, lr=0.05,
                                                          zo_lr=0.05 / d)
            step = make.make_zo_step(quad_loss if make is TD else jquad_loss, msh, cfg, opt,
                                     m=m, fsdp=kw.get("fsdp", False))
        step = led.wrap(which, step if make is TD else jax.jit(step))
        tt = 0 if which == "fo" else 1
        p2, _, _ = step(tt if make is TD else jnp.int32(tt), params, opt.init(params), batch)
        out.append((led.bytes_per_step(which), p2))
    assert out[0][0] == out[1][0]
    return out[0]


@pytest.mark.parametrize("m", [1, 4])
def test_ledger_books_4d_fo_and_4m_zo(mesh, m):
    d = 64
    assert _one_step_bytes(mesh, "fo", m=m)[0] == 4 * d
    assert _one_step_bytes(mesh, "zo", m=m)[0] == 4 * m


def test_fsdp_zo_books_its_one_scalar(mesh):
    assert _one_step_bytes(mesh, "zo", m=None, fsdp=True)[0] == 4


@pytest.mark.parametrize("m", [1, 4])
def test_per_worker_codec_books_nbytes_times_workers(mesh, m):
    d, nb = 64, qsgd(8).nbytes(64)
    pw = _one_step_bytes(mesh, "fo", m=m, compressor=8, compress_mode="per_worker")[0]
    legacy = _one_step_bytes(mesh, "fo", m=m, compressor=8, compress_mode="legacy")[0]
    assert pw == nb * m and legacy == nb < 4 * d


def test_codec_with_grad_accum_falls_back_to_legacy(mesh):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fo = TD.make_fo_step(quad_loss, mesh, sgd(const_schedule(0.05)), grad_accum=2,
                             compressor=qsgd(8), m=4)
    assert any("legacy" in str(w.message) for w in caught)
    led = CommLedger()
    led.wrap("fo", fo)(0, {"x": torch.zeros(64)}, (), {"t": torch.ones(8, 64)})
    assert led.bytes_per_step("fo") == qsgd(8).nbytes(64)


@pytest.mark.parametrize("buckets", [1, 2, 5, 8])
def test_buckets_bit_identical_params_and_equal_bytes(mesh, buckets):
    d = 96
    plain = _one_step_bytes(mesh, "fo", d=d)
    nb, p = _one_step_bytes(mesh, "fo", d=d, buckets=buckets)
    assert nb == plain[0] == 4 * d and torch.equal(p["x"], plain[1]["x"])
    assert _one_step_bytes(mesh, "fo", d=d, buckets=buckets, compressor=4)[0] == qsgd(4).nbytes(d)


def test_sharded_placements_raise_until_their_port(mesh, ranks):
    """The placements that once raised build and take a step: fsdp
    over several data ranks and specs that cut a leaf over ``model`` (on
    the 4 spawned ranks, (data=2, model=2): each rank holds half of x, the
    step moves it, and every rank gathers the same x); and the pallas
    engine on a column-parallel shard of many runs (129 of 2), once refused
    for its per-run launches, now one call per primitive with a run table,
    its perturb and reconstruct bit for bit the tree engine's."""
    from repro_torch.core.engine import make_engine
    from repro_torch.dist.sharding import P

    opt = sgd(const_schedule(0.1))
    TD.make_zo_step(quad_loss, _Shape(data=4, model=2), H.ho_config("tree"), opt, fsdp=True)
    TD.make_zo_step(quad_loss, _Shape(data=1, model=2), H.ho_config("tree"), opt, m=4,
                    param_specs_tree={"x": P("model")})
    # specs that keep every parameter whole run, on the generic path
    TD.make_zo_step(quad_loss, mesh, H.ho_config("tree"), opt, m=4, param_specs_tree={"x": P()})
    _, res = ranks
    for out in res:
        for case in ("model", "fsdp"):
            got = out["sharded"][case]
            assert got["held"] == [(DIM // 2,)]
            np.testing.assert_array_equal(got["x"], res[0]["sharded"][case]["x"])
            assert np.isfinite(got["losses"]).all()
            assert float(np.abs(got["x"] - x0()["x"].numpy()).max()) > 0
    column = H.FakeMesh(dict(data=0, model=1), data=1, model=2)
    x = {"x": torch.linspace(-1.0, 1.0, 129 * 2).reshape(129, 1, 2)}
    engines = [make_engine(e, x, 0, specs=[P(None, None, "model")], mesh=column)
               for e in ("pallas", "tree")]
    for eng in engines:            # the norm a group would reduce: one worker's, by hand
        eng._inv_norms = lambda t, workers: torch.ones(len(workers))
    pal, tree = engines
    assert tuple(pal.starts[0].shape) == (129,)
    assert torch.equal(pal.perturb(x, 2, 1, 0.5)["x"], tree.perturb(x, 2, 1, 0.5)["x"])
    c = torch.tensor([0.5, -2.0])
    assert torch.equal(pal.reconstruct(c, 2)["x"], tree.reconstruct(c, 2)["x"])


# --------------------------------------------------------------------------- #
# one rank per worker: 4 spawned gloo ranks
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    init = str(tmp_path_factory.mktemp("pg") / "init")
    batches = data()
    return batches, spawn_ranks(H.run_cases, 4, init, batches, STEPS, timeout=240)


def test_ranks_get_their_own_rows(ranks):
    batches, res = ranks
    for r, out in enumerate(res):
        for name, *_ in H.CASES:
            w = out[name]["worker"]
            assert [x.tolist() for x in out[name]["rows"]] == \
                [b["t"][2 * w:2 * w + 2].tolist() for b in batches]
    assert sorted(out["flat-pod"]["worker"] for out in res) == [0, 1, 2, 3]


@pytest.mark.parametrize("case", [c[0] for c in H.CASES])
def test_rank_per_worker_matches_one_process(mesh, ranks, case):
    batches, res = ranks
    _, _, engine, codec, mode = next(c for c in H.CASES if c[0] == case)
    fo, zo = TD.make_distributed_ho_sgd(quad_loss, mesh, H.ho_config(engine),
                                        compressor=None if codec is None else qsgd(8),
                                        compress_mode=mode)
    led = CommLedger()
    fo, zo = led.wrap("fo", fo), led.wrap("zo", zo)
    p, s, losses = x0(), (), []
    for t, b in enumerate(batches):
        p, s, loss = (fo if t % H.TAU == 0 else zo)(t, p, s, b)
        losses.append(float(loss))
    # legacy QSGD rounds the mean gradient, which the ranks sum in another
    # order: a stochastic rounding may flip, and the ZO coefficients after it
    # amplify that (the 2%-of-the-update rule holds the parameters)
    rtol = 1e-3 if mode == "legacy" else 1e-6
    for out in res:
        np.testing.assert_array_equal(out[case]["x"], res[0][case]["x"])
        np.testing.assert_allclose(out[case]["losses"], losses, rtol=rtol)
    assert_update_close(res[0][case]["x"], p["x"].numpy(), x0()["x"].numpy(), case)
    zo_bytes = res[0][case]["zo_bytes"]
    assert zo_bytes == led.bytes_per_step("zo") == 4 * M
    assert res[0][case]["fo_bytes"] == led.bytes_per_step("fo") == \
        (4 * DIM if codec is None else qsgd(8).nbytes(DIM) * (M if mode == "per_worker" else 1))
    assert res[0][case]["zo_kinds"] == {"all_gather:zo_coeffs": 4 * M, "pmean:loss": 4}


def test_process_group_collectives(ranks):
    _, res = ranks
    for out in res:
        np.testing.assert_array_equal(out["gather"], [0.0, 1.0, 2.0, 3.0])
        assert out["psum"] == 6.0
    # pmean over "data" alone: the two workers of one pod
    assert sorted(out["pmean_data"] for out in res) == [0.5, 0.5, 2.5, 2.5]


def test_collectives_without_a_mesh_raise():
    from repro_torch.dist import collectives as coll

    with pytest.raises(RuntimeError, match="process group"):
        coll.all_gather(torch.zeros(()), "data", mesh=None)
