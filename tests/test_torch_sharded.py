"""Sharded parameter placements on the CPU: ``dist.sharding``'s geometry and
gathers, the engines over shards (``core.engine``), the process-group steps
(``core.distributed``) and the trainer (``launch.train``).

* Geometry (no group; a mesh given by its sizes and this rank's
  coordinates): for every placement rule ``param_specs`` makes (column,
  row, the embedding's vocab rows, the expert dim, fsdp's largest dim,
  an fsdp vector) and every coordinate of a (data=2, model=2) mesh, a
  shard's direction from the ``tree``, ``fused``, ``flat`` (plain
  versions) and ``pallas`` (a run table) engines is bit for bit the slice of
  the whole leaf's direction, and a shard generated with local counters is
  not (the control); the flat layout keeps counters past 2**32 (wrapped
  as the hash wraps them); the flat block comes from the runs; an engine's
  ``dim`` is the global d; the ``pallas`` engine on the shards of every
  rule, on (data=1, model=2) and (data=2, model=2): one kernel call per
  leaf and primitive whatever its runs (a column-parallel shard of 129
  runs too), its perturb and reconstruct bit for bit ``tree``'s and
  ``flat``'s, and within the reference's ``pallas`` engine's parity rules
  (rtol 1e-5 / atol 1e-6: the Gaussians' ulps between the two math
  libraries) of the whole leaf's, sliced by ``shard_slices``; the fused flat
  pair raises under sharded specs.
* 8 spawned gloo ranks, (data=4, model=2), qwen3-14b reduced from the
  reference's parameters (tests/helpers/dist_check.py's case), the forward
  partitioned over ``model``: one ZO step at t=5 with m=4 on ``tree`` and
  ``flat``: the gathered parameters within 2e-5 of the reference's
  single-host ``make_ho_sgd`` step (the distributed check's bound) and
  within 2% of the update of the port's one-process step at m=4; every
  rank's f0 within rtol 1e-6 of its worker's in that step (a row-parallel
  product sums float32 partials in another order than one process's
  product: the losses part by ulps, 7.7e-8 relative here), and bit for bit
  the same on the two ranks of a worker (every loss evaluation); the
  engines' d is the global d and their Σv² the whole tree's; rank 0 books
  4·m per ZO step; an FO step within 2e-5 of the reference's and within
  rtol 1e-6 / atol 1e-7 of the one-process step, booking 4·d (with
  per-worker QSGD, the global leaves' ``nbytes`` x m); the ranks of one
  worker get the same rows.
* 4 ranks, (data=2, model=2): qwen3-moe reduced under fsdp (every rank the
  whole batch, m=1): the ZO step within 2e-5 of the reference's m=1 step
  and 2% of the update of the port's one-process step, every rank's f0
  within rtol 1e-6 of the one-process f0 and the same bits on all four;
  the FO step within 2% of the update of the one-process step, its loss
  within rtol 1e-6; then ``launch.train.main`` at ``--model-axis
  4`` (m=1): order, CSV bytes and losses (rtol 1e-5) of the one-rank CLI,
  and at ``--model-axis 2`` (m=2): the order, FO bytes, 4·m ZO bytes; the
  sharded ``--ckpt`` restores through ``repro.checkpoint.restore`` bit for
  bit the gathered parameters that rank 0 saved, and through the port's
  ``restore(..., shards=)`` as each rank's slice.
* 4 ranks, (data=2, model=2), fsdp off: qwen3-moe reduced, 6 steps at tau
  4 with m=2, every rank the global batch: the losses within 5e-7 of the
  one-process m=2 run (the FO step's gradient is the global batch's, so the
  MoE capacity and load-balance loss are too) and the final parameters
  within 2% of its update; the ZO steps' loss sees the worker's rows, the
  per-worker codec's FO step too, the legacy codec's the global batch; a
  dense FO step (qwen3-14b) bit for bit the rank-per-worker step written
  out.
* 2 ranks, (data=1, model=2): the FO step within rtol 1e-6 in loss and 2%
  of the update of the one-process step (it was bit for bit while every
  rank computed the whole model on gathered leaves; the partitioned
  forward sums float32 partials in rank order), and the same step without
  the MLP's all-reduce outside both (the control); the ``pallas`` engine's
  run table on a leaf cut into three runs against the ``tree``
  engine.

The reference's ``HAS_PARTIAL_AUTO_COLLECTIVES`` is switched off by an
autouse fixture, as in tests/test_torch_distributed.py.
"""
import csv
import functools
import itertools
import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_helpers as H
from repro import compat
from repro.checkpoint import restore as jrestore
from repro.configs import get_config as jget_config
from repro.core.ho_sgd import HOSGDConfig as JCfg, make_ho_sgd as jmake_ho_sgd
from repro.models import transformer as JT
from repro_torch.checkpoint import restore
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import directions as D
from repro_torch.core import distributed as TD
from repro.core.engine import make_engine as jmake_engine
from repro_torch.core.engine import MIN_SHARD_BLOCK, flat_layout, make_engine, shard_block
from repro_torch.dist import CommLedger
from repro_torch.dist import sharding as S
from repro_torch.dist.compress import qsgd
from repro_torch.dist.sharding import P
from repro_torch.kernels import ops
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import init_rank, make_test_mesh, spawn_ranks
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def reference_auto_branch(monkeypatch):
    monkeypatch.setattr(compat, "HAS_PARTIAL_AUTO_COLLECTIVES", False)


FakeMesh = H.FakeMesh
SIZES = dict(data=2, model=2)
COORDS = [dict(data=a, model=b) for a, b in itertools.product(range(2), range(2))]
#: rule -> (dict path, global shape, the spec param_specs gives it at SIZES)
RULES = {
    "column": (("layers", "attn", "wq"), (3, 8, 12), P(None, None, "model")),
    "row": (("layers", "attn", "wo"), (3, 12, 8), P(None, "model")),
    "embed-rows": (("embed",), (16, 8), P("model")),
    "expert-dim": (("layers", "moe", "wg"), (3, 4, 8, 6), P(None, "model")),
    "fsdp-largest": (("layers", "mlp", "wu"), (3, 8, 24), P(None, "data", "model")),
    "fsdp-vector": (("final_norm", "scale"), (24,), P("data")),
}
ENGINES = ["tree", "fused", "flat", "pallas"]


def _nest(path, x):
    for name in reversed(path):
        x = {name: x}
    return x


@pytest.mark.parametrize("rule", sorted(RULES))
def test_param_specs_give_each_rule(rule):
    path, shape, spec = RULES[rule]
    cfg = types.SimpleNamespace(fsdp=rule.startswith("fsdp"),
                                moe_sharding="expert" if rule == "expert-dim" else "tensor")
    like = _nest(path, torch.empty(shape, device="meta"))
    got = tree_leaves(S.param_specs(cfg, like, FakeMesh(COORDS[0], **SIZES)))
    assert got == [spec]


def _whole_direction(shape, salt):
    return D.gaussian_from_salt(shape, salt)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("rule", sorted(RULES))
def test_shard_directions_are_slices_of_the_whole_leaf(rule, engine):
    """Every coordinate's shard direction is bit for bit the slice of the
    whole leaf's (perturbing zeros by 1 gives v); one generated with the
    shard's local counters is not, on some coordinate (the control)."""
    _, shape, spec = RULES[rule]
    salt = D.fold(7, 3, 2, 0)
    whole = _whole_direction(shape, salt)
    local_differs = False
    for coord in COORDS:
        mesh = FakeMesh(coord, **SIZES)
        geom = S.ShardGeometry([spec], [shape], S.mesh_shape(mesh), coord)
        zeros = {"x": torch.zeros(geom.local_shapes[0])}
        eng = make_engine(engine, zeros, 7, specs=[spec], mesh=mesh)
        want = whole[geom.slices[0]]
        assert torch.equal(eng.perturb(zeros, 3, 2, 1.0)["x"], want), coord
        if engine == "flat":
            rec = ops.zo_reconstruct_flat(eng.blk_salts_multi(3, [2]), torch.ones(1),
                                          eng._blk_ctr, eng._blk_nv, block=eng.block)
            assert torch.equal(eng.unpack(rec, cast=False)["x"], want), coord
        local_differs |= not torch.equal(
            D.gaussian_from_salt(geom.local_shapes[0], salt), want)
    assert local_differs, "the control: local counters must differ from the slice"


def test_layout_counters_past_2_32():
    """A (4, 2**31) leaf cut on its last dim: the runs start at global
    indices past 2**32, the flat blocks' counters are those indices mod
    2**32, and a block's Gaussians equal the whole leaf's at that offset."""
    shape, spec = (4, 2 ** 31), P(None, "model")
    sl = S.shard_slices(spec, shape, {"model": 2}, {"model": 1})
    starts, n = S.leaf_runs(shape, sl)
    assert n == 2 ** 30 and starts.tolist() == [r * 2 ** 31 + 2 ** 30 for r in range(4)]
    block = 2 ** 28
    leaf, ctr, nv = flat_layout([(starts, n)], block)
    want = [(s + k * block) % 2 ** 32 for s in starts.tolist() for k in range(4)]
    assert ctr.astype(np.int64).tolist() == want and (nv == block).all() and (leaf == 0).all()
    b = 8                                    # run 2's first block: index 2**32 + 2**30
    assert int(starts[2]) > 2 ** 32 and int(ctr[b]) == 2 ** 30
    salt = D.fold(0, 1, 0, 0)
    lanes = torch.arange(16, dtype=torch.int64)
    got = D.gaussian_from_counters((int(ctr[b]) + lanes) & D.MASK, salt)
    assert torch.equal(got, D.gaussian_from_salt((16,), salt, offset=int(starts[2])))


def test_flat_block_is_picked_from_the_runs():
    """Runs of 512 (gemma2-2b's ``wk`` at model=2) take blocks of 512,
    whole leaves 4096; the packed buffer stays within 1/64 of the shard."""
    wk = (np.zeros(26 * 2304, np.int64), 512)
    wo = (np.zeros(26, np.int64), 1024 * 2304)
    norm = (np.zeros(1, np.int64), 2304)
    assert shard_block([wk, wo, norm]) == 512
    assert shard_block([wo, norm]) == 4096           # one short leaf pads little
    assert shard_block([(np.zeros(1000, np.int64), 2304)]) == 256
    assert shard_block([(np.zeros(1, np.int64), 10 ** 6)]) == 4096
    assert shard_block([(np.zeros(1000, np.int64), 7)]) == MIN_SHARD_BLOCK
    mesh = FakeMesh(COORDS[3], **SIZES)
    _, shape, spec = RULES["column"]
    eng = make_engine("flat", {"x": torch.zeros(3, 8, 6)}, 0, specs=[spec], mesh=mesh)
    assert eng.block == MIN_SHARD_BLOCK and eng.packed_over_shard == 64 / 6


def test_engine_dim_is_the_global_d():
    _, shape, spec = RULES["fsdp-largest"]
    mesh = FakeMesh(COORDS[1], **SIZES)
    for engine in ENGINES:
        eng = make_engine(engine, {"x": torch.zeros(3, 4, 12)}, 0, specs=[spec], mesh=mesh)
        assert eng.dim == 3 * 8 * 24 and sum(eng.sizes) == 3 * 4 * 12
    # specs that cut nothing over an axis of more than one rank: the engine
    # is the unsharded one
    one = FakeMesh(dict(data=0, model=0), data=1, model=1)
    eng = make_engine("flat", {"x": torch.zeros(3, 8, 24)}, 0, specs=[spec], mesh=one)
    assert eng.geometry is None and eng.block == 4096


def test_pallas_column_shard_raises_and_fused_pair_refuses_shards():
    """A column-parallel shard of 129 runs (once past the per-run launch
    limit, which raised) builds the ``pallas`` engine: a run table of 129
    starts, its perturb bit for bit ``tree``'s; the fused flat pair still
    refuses shards."""
    mesh = FakeMesh(COORDS[1], **SIZES)
    spec = P(None, None, "model")
    x = {"x": torch.randn(129, 1, 4, generator=torch.Generator().manual_seed(0))}
    pal = make_engine("pallas", x, 0, specs=[spec], mesh=mesh)
    assert pal.starts[0].dtype == torch.uint32 and pal.starts[0].shape == (129,)
    assert torch.equal(pal.perturb(x, 1, 0, 0.5)["x"],
                       make_engine("tree", x, 0, specs=[spec], mesh=mesh).perturb(x, 1, 0, 0.5)["x"])
    eng = make_engine("flat", x, 0, specs=[spec], mesh=mesh)
    with pytest.raises(ValueError, match="global"):
        eng.fused_perturb_sumsq(eng.pack(x), 1, 0, 1e-3)


#: (data, model) meshes the pallas engine's shards are held on
PALLAS_MESHES = {"data1-model2": dict(data=1, model=2), "data2-model2": SIZES}
PALLAS_RULES = ("column", "row", "fsdp-largest", "fsdp-vector", "embed-rows", "expert-dim")


def _pallas_cases(rule, mesh_name):
    """Per coordinate of the mesh: ``(mesh, geometry, this rank's shard of
    a random whole leaf, the whole leaf)`` for a rule of ``RULES``."""
    _, shape, _ = RULES[rule]
    sizes = PALLAS_MESHES[mesh_name]
    cfg = types.SimpleNamespace(fsdp=rule.startswith("fsdp"),
                                moe_sharding="expert" if rule == "expert-dim" else "tensor")
    path = RULES[rule][0]
    whole = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    for a, b in itertools.product(range(sizes["data"]), range(sizes["model"])):
        coord = dict(data=a, model=b)
        mesh = FakeMesh(coord, **sizes)
        spec = tree_leaves(S.param_specs(cfg, _nest(path, whole), mesh))[0]
        geom = S.ShardGeometry([spec], [shape], S.mesh_shape(mesh), coord)
        yield mesh, spec, geom, whole[geom.slices[0]].contiguous(), whole


def _whole_norms(eng, whole):
    """``eng``'s per-worker inverse norms taken from an engine over the whole
    leaf (the global norm; on a process group it is one collective)."""
    ref = make_engine("tree", {"x": whole}, eng.seed)
    eng._inv_norms = lambda t, workers: ref._inv_norms(t, workers)
    return eng


@pytest.mark.parametrize("mesh_name", sorted(PALLAS_MESHES))
@pytest.mark.parametrize("rule", PALLAS_RULES)
def test_pallas_shards_bit_for_bit_tree_and_flat_one_call_per_leaf(rule, mesh_name, monkeypatch):
    calls = {"zo_perturb": 0, "zo_reconstruct": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    coeffs = torch.tensor([0.5, -1.0, 2.0])
    for mesh, spec, geom, shard, whole in _pallas_cases(rule, mesh_name):
        x = {"x": shard}
        engines = {e: _whole_norms(make_engine(e, x, 7, specs=[spec], mesh=mesh), whole)
                   for e in ("pallas", "tree", "flat")}
        before = dict(calls)
        got = engines["pallas"].perturb(x, 3, 2, 0.25)["x"]
        rec = engines["pallas"].reconstruct(coeffs, 3, [0, 2, 5])["x"]
        assert {k: calls[k] - before[k] for k in calls} == {"zo_perturb": 1,
                                                           "zo_reconstruct": 1}
        for e in ("tree", "flat"):
            assert torch.equal(got, engines[e].perturb(x, 3, 2, 0.25)["x"]), (e, mesh._coord)
            assert torch.equal(rec, engines[e].reconstruct(coeffs, 3, [0, 2, 5])["x"]), e


@pytest.mark.parametrize("mesh_name", sorted(PALLAS_MESHES))
@pytest.mark.parametrize("rule", ["column", "row", "fsdp-largest"])
def test_pallas_shards_match_the_reference_pallas_engine_sliced(rule, mesh_name):
    coeffs = np.asarray([0.5, -1.0, 2.0], np.float32)
    for mesh, spec, geom, shard, whole in _pallas_cases(rule, mesh_name):
        jx = {"x": jnp.asarray(whole.numpy())}
        je = jmake_engine("pallas", jx, 7, block=64)
        jinv = float(jax.jit(je.inv_norm)(jnp.int32(3), jnp.uint32(2)))
        jout = jax.jit(lambda p: je.perturb(p, jnp.int32(3), jnp.uint32(2),
                                            jnp.float32(0.25 * jinv)))(jx)["x"]
        jrec = jax.jit(lambda: je.reconstruct(jnp.asarray(coeffs), jnp.int32(3)))()["x"]
        eng = _whole_norms(make_engine("pallas", {"x": shard}, 7, specs=[spec], mesh=mesh),
                           whole)
        got = eng.perturb({"x": shard}, 3, 2, torch.tensor(0.25 * jinv))["x"]
        sl = geom.slices[0]
        np.testing.assert_allclose((got - shard).numpy(), np.asarray(jout)[sl] - shard.numpy(),
                                   rtol=1e-5, atol=1e-6)
        rec = eng.reconstruct(torch.from_numpy(coeffs), 3)["x"]
        np.testing.assert_allclose(rec.numpy(), np.asarray(jrec)[sl], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# process groups
# --------------------------------------------------------------------------- #
def _batch(vocab, rows=8, seq=16):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (rows, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((rows, 1), np.int32)], 1)
    return {"tokens": toks, "labels": labels}


def _ref(arch, fsdp=False):
    jcfg = jget_config(arch).reduced()
    if fsdp:
        jcfg = jcfg.with_(fsdp=True)
    jp = JT.init_model(jax.random.key(0), jcfg)
    return jcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def qwen():
    return _ref("qwen3-14b")


@pytest.fixture(scope="module")
def moe():
    return _ref("qwen3-moe-235b-a22b", fsdp=True)


@pytest.fixture(scope="module")
def one():
    """A one-rank gloo group and its 1x1 mesh: the one-process steps."""
    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, 1, os.path.join(tmp, "init"))
        try:
            yield make_test_mesh(data=1, model=1, device="cpu")
        finally:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def eight(qwen, tmp_path_factory):
    batch = _batch(512)
    return batch, spawn_ranks(H.run_sharded_8, 8, str(tmp_path_factory.mktemp("pg8") / "init"),
                              qwen[2], batch, timeout=420)


@pytest.fixture(scope="module")
def four(moe, tmp_path_factory):
    batch = _batch(512)
    tmp = tmp_path_factory.mktemp("cli")
    return batch, str(tmp), spawn_ranks(H.run_sharded_4, 4, str(tmp / "init"), moe[2], batch,
                                        str(tmp), timeout=420)


@pytest.fixture(scope="module")
def two(qwen, tmp_path_factory):
    batch = _batch(512)
    quad = {"t": np.random.default_rng(1).normal(size=(4, 144)).astype(np.float32)}
    return batch, quad, spawn_ranks(H.run_sharded_2, 2, str(tmp_path_factory.mktemp("pg2") /
                                                            "init"), qwen[2], batch, quad,
                                    timeout=420)


MOE_STEPS = 6


def _moe_batches():
    return [{k: np.roll(v, 3 * i, axis=1) for k, v in _batch(512).items()}
            for i in range(MOE_STEPS)]


@pytest.fixture(scope="module")
def moe4(moe, qwen, tmp_path_factory):
    return spawn_ranks(H.run_moe_4, 4, str(tmp_path_factory.mktemp("moe4") / "init"), moe[2],
                       qwen[2], _moe_batches(), MOE_STEPS, timeout=420)


def _one_process(cfg, np_tree, batch, mesh, ho, kind, t, **kw):
    """The port's one-process step (a 1x1 mesh, m workers held here):
    ``(params, loss, every loss evaluation in order, ledger bytes)``."""
    full = params_from_numpy(np_tree, device="cpu")
    losses = []

    def loss(p, b):
        out = T.loss_fn(cfg, p, b)
        losses.append(float(out.detach()))
        return out

    fo, zo = TD.make_distributed_ho_sgd(loss, mesh, ho, model_cfg=cfg, params_like=full, **kw)
    led = CommLedger()
    p, _, out = led.wrap(kind, fo if kind == "fo" else zo)(t, full, (), batch)
    return [x.numpy() for x in tree_leaves(p)], float(out), losses, led.bytes_per_step(kind)


@functools.lru_cache(maxsize=None)
def _reference_zo(arch, m):
    """The reference's single-host ``make_ho_sgd`` step at t=5 from its own
    parameters (``_ref``) on ``_batch``."""
    jcfg, jp, _ = _ref(arch, fsdp=m == 1)
    batch = _batch(512)
    d = sum(x.size for x in jax.tree.leaves(jp))
    ref = jmake_ho_sgd(lambda p, b: JT.loss_fn(jcfg, p, b),
                       JCfg(tau=1 << 30, mu=1e-3, m=m, lr=0.05, zo_lr=0.05 / d, seed=0))
    pr, _, _ = ref.step(H.ZO_T, jp, ref.init(jp), jax.tree.map(jnp.asarray, batch))
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(pr)]


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def assert_update_close(got, want, start, what=""):
    """|got - want| <= 2% of the largest update (+1e-7), leaf by leaf."""
    scale = max(float(np.abs(w - s).max()) for w, s in zip(want, start))
    diff = _max_diff(got, want)
    assert scale > 0 and diff <= 0.02 * scale + 1e-7, (what, diff, scale)


def _d(np_tree):
    return sum(x.size for x in jax.tree.leaves(np_tree))


@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_zo_step_on_data4_model2_matches_reference_and_one_process(qwen, eight, one, engine):
    _, _, np_tree = qwen
    batch, res = eight
    cfg, d = get_config("qwen3-14b").reduced(), _d(np_tree)
    start = [np.asarray(x) for x in jax.tree.leaves(np_tree)]
    got = res[0][f"zo-{engine}"]["params"]
    assert _max_diff(got, _reference_zo("qwen3-14b", 4)) < 2e-5
    p1, loss1, losses1, bytes1 = _one_process(cfg, np_tree, batch, one,
                                              H.llm_config(d, 4, engine), "zo", H.ZO_T)
    assert_update_close(got, p1, start, engine)
    for out in res:
        r = out[f"zo-{engine}"]
        assert r["checksum"] == res[0][f"zo-{engine}"]["checksum"]
        np.testing.assert_allclose(r["f0"], losses1[2 * out["worker"]], rtol=1e-6)
        np.testing.assert_allclose(r["loss"], loss1, rtol=1e-6)
        # the ranks of one worker: every loss evaluation the same bits
        mate = next(o for o in res if o["worker"] == out["worker"] and o is not out)
        assert r["losses"] == mate[f"zo-{engine}"]["losses"]
    assert res[0][f"zo-{engine}"]["bytes"] == bytes1 == 4 * 4


def test_shards_hold_only_their_part_and_ranks_of_a_worker_share_rows(qwen, eight):
    _, _, np_tree = qwen
    batch, res = eight
    whole = [x.shape for x in jax.tree.leaves(np_tree)]
    for out in res:
        held = out["zo-flat"]["held"]
        assert sum(np.prod(h) for h in held) < sum(np.prod(w) for w in whole)
        assert any(h != w for h, w in zip(held, whole))
        w = out["worker"]
        np.testing.assert_array_equal(out["fo"]["rows"], batch["tokens"][2 * w:2 * w + 2])
    assert sorted(out["worker"] for out in res) == [0, 0, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_engine_dim_and_norm_are_global(qwen, eight, engine):
    _, _, np_tree = qwen
    _, res = eight
    full = params_from_numpy(np_tree, device="cpu")
    whole = make_engine(engine, full, 0)
    want = [float(whole.sumsq(H.ZO_T, w)) for w in range(4)]
    for out in res:
        pins = out[f"pins-{engine}"]
        assert pins["dim"] == whole.dim == _d(np_tree)
        np.testing.assert_allclose(pins["sumsq"], want, rtol=1e-6)
    if engine == "flat":
        assert res[0]["pins-flat"]["packed_over_shard"] <= 1 + 1 / 64


@functools.lru_cache(maxsize=None)
def _reference_fo(arch, m):
    """The reference's single-host ``make_ho_sgd`` FO step at t=0 (tau 4)
    from its own parameters (``_ref``) on ``_batch``."""
    jcfg, jp, _ = _ref(arch, fsdp=m == 1)
    d = sum(x.size for x in jax.tree.leaves(jp))
    ref = jmake_ho_sgd(lambda p, b: JT.loss_fn(jcfg, p, b),
                       JCfg(tau=4, mu=1e-3, m=m, lr=0.05, zo_lr=0.05 / d, seed=0))
    pr, _, _ = ref.step(0, jp, ref.init(jp), jax.tree.map(jnp.asarray, _batch(512)))
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(pr)]


def test_fo_step_on_data4_model2_and_its_bytes(qwen, eight, one):
    _, _, np_tree = qwen
    batch, res = eight
    cfg, d = get_config("qwen3-14b").reduced(), _d(np_tree)
    assert _max_diff(res[0]["fo"]["params"], _reference_fo("qwen3-14b", 4)) < 2e-5
    p1, loss1, _, bytes1 = _one_process(cfg, np_tree, batch, one, H.llm_config(d, 4), "fo", 0)
    for a, b in zip(res[0]["fo"]["params"], p1):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(res[0]["fo"]["loss"], loss1, rtol=1e-6)
    assert res[0]["fo"]["bytes"] == bytes1 == 4 * d
    _, _, _, qbytes1 = _one_process(cfg, np_tree, batch, one, H.llm_config(d, 4), "fo", 0,
                                    compressor=qsgd(8))
    want = 4 * sum(qsgd(8).nbytes(x.size) for x in jax.tree.leaves(np_tree))
    assert res[0]["fo-qsgd"]["bytes"] == qbytes1 == want
    assert all(out["fo"]["checksum"] == res[0]["fo"]["checksum"] for out in res)


def test_fo_step_on_model2_is_bit_for_bit_the_one_process_step(qwen, two, one):
    """Now within the partitioned forward's tolerances (losses rtol 1e-6,
    parameters 2% of the update), and the control without the MLP's
    all-reduce outside both."""
    _, _, np_tree = qwen
    batch, _, res = two
    cfg, d = get_config("qwen3-14b").reduced(), _d(np_tree)
    start = [np.asarray(x) for x in jax.tree.leaves(np_tree)]
    p1, loss1, _, bytes1 = _one_process(cfg, np_tree, batch, one, H.llm_config(d, 4), "fo", 0)
    assert_update_close(res[0]["fo"]["params"], p1, start, "model2 fo")
    np.testing.assert_allclose(res[0]["fo"]["loss"], loss1, rtol=1e-6)
    assert res[0]["fo"]["bytes"] == bytes1 == 4 * d
    bad = res[0]["fo-no-mlp-reduce"]
    assert abs(bad["loss"] - loss1) > 1e-6 * abs(loss1)
    with pytest.raises(AssertionError):
        assert_update_close(bad["params"], p1, start, "control")


def test_pallas_runs_its_kernels_per_run_of_a_row_shard(two):
    _, quad, res = two
    start = np.linspace(-1.0, 1.0, 144, dtype=np.float32).reshape(3, 8, 6)
    pal, tree = res[0]["quad-pallas"], res[0]["quad-tree"]
    assert pal["loss"] == tree["loss"]
    assert_update_close([pal["w"]], [tree["w"]], [start], "pallas run table")
    assert float(np.abs(pal["w"] - start).max()) > 0
    assert all(np.array_equal(out["quad-pallas"]["w"], pal["w"]) for out in res)


def test_fsdp_moe_on_data2_model2_matches_reference_and_one_process(moe, four, one):
    _, _, np_tree = moe
    batch, _, res = four
    cfg, d = get_config("qwen3-moe-235b-a22b").reduced().with_(fsdp=True), _d(np_tree)
    start = [np.asarray(x) for x in jax.tree.leaves(np_tree)]
    zo = res[0]["zo"]
    assert _max_diff(zo["params"], _reference_zo("qwen3-moe-235b-a22b", 1)) < 2e-5
    p1, loss1, losses1, zbytes = _one_process(cfg, np_tree, batch, one, H.llm_config(d, 1),
                                              "zo", H.ZO_T)
    assert_update_close(zo["params"], p1, start, "fsdp zo")
    np.testing.assert_allclose(zo["f0"], losses1[0], rtol=1e-6)
    assert all(out["zo"]["losses"] == zo["losses"] for out in res) and zo["bytes"] == zbytes == 4
    f1, floss, _, fbytes = _one_process(cfg, np_tree, batch, one, H.llm_config(d, 1), "fo", 0)
    assert_update_close(res[0]["fo"]["params"], f1, start, "fsdp fo")
    np.testing.assert_allclose(res[0]["fo"]["loss"], floss, rtol=1e-6)
    assert res[0]["fo"]["bytes"] == fbytes == 4 * d
    held = res[0]["fo"]["held"]
    # the data axis cuts leaves too: held bytes below the model axis's half
    assert sum(np.prod(h) for h in held) < 0.5 * d
    assert res[0]["pins"]["dim"] == d


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_sharded_trainer_cli_and_its_checkpoint(four, one, tmp_path):
    _, tmp, res = four
    TT.main(H.SMOKE + ["--log", str(tmp_path / "one.csv")])
    base = _csv(tmp_path / "one.csv")
    d = get_config("gemma2-2b").reduced().param_count()
    m4, m2 = _csv(os.path.join(tmp, "model4.csv")), _csv(os.path.join(tmp, "model2.csv"))
    assert [r["order"] for r in m4] == [r["order"] for r in base] == ["1", "0", "0"] * 3
    assert [r["comm_bytes"] for r in m4] == [r["comm_bytes"] for r in base]
    np.testing.assert_allclose([float(r["loss"]) for r in m4],
                               [float(r["loss"]) for r in base], rtol=1e-5)
    assert [r["order"] for r in m2] == [r["order"] for r in base]
    assert [int(r["comm_bytes"]) for r in m2] == [4 * d, 4 * 2, 4 * 2] * 3
    assert all(np.isfinite(float(r["loss"])) for r in m2)
    jcfg = jget_config("gemma2-2b").reduced()
    jlike = JT.init_model(jax.random.key(0), jcfg)
    for axis in (2, 4):
        ck = os.path.join(tmp, f"model{axis}-ck")
        saved = res[0]["saved"][ck]
        jp, step = jrestore(ck, jlike)
        assert step == 9
        assert all(np.array_equal(np.asarray(a), b)
                   for a, b in zip(jax.tree.leaves(jp), saved))
    # the port's restore onto a sharded mesh: each coordinate's slice
    cfg = get_config("gemma2-2b").reduced()
    like = T.init_model(0, cfg, device="cpu")
    for coord in COORDS:
        mesh = FakeMesh(coord, **SIZES)
        geom = S.ShardGeometry.from_global(S.param_specs(cfg, like, mesh), like, mesh)
        got, _ = restore(os.path.join(tmp, "model2-ck"), like, shards=geom)
        saved = res[0]["saved"][os.path.join(tmp, "model2-ck")]
        for i, (x, s) in enumerate(zip(tree_leaves(got), saved)):
            assert tuple(x.shape) == geom.local_shapes[i]
            assert np.array_equal(x.numpy(), s[geom.slices[i]])


def test_moe_fo_on_data2_model2_takes_the_global_batch(moe, moe4, one):
    _, _, np_tree = moe
    cfg, d = get_config("qwen3-moe-235b-a22b").reduced(), _d(np_tree)
    assert not cfg.fsdp and TD.takes_whole_batch(cfg)
    full = params_from_numpy(np_tree, device="cpu")
    fo, zo = TD.make_distributed_ho_sgd(lambda p, b: T.loss_fn(cfg, p, b), one,
                                        H.llm_config(d, 2), model_cfg=cfg, params_like=full)
    p, losses = full, []
    for t, b in enumerate(_moe_batches()):
        p, _, loss = (fo if t % H.TAU == 0 else zo)(t, p, (), b)
        losses.append(float(loss))
    start = [np.asarray(x) for x in jax.tree.leaves(np_tree)]
    want = [x.numpy() for x in tree_leaves(p)]
    for out in moe4:
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
        assert rel <= 5.0e-7, (out["losses"], losses)
        assert out["bytes"] == [4 * d if t % H.TAU == 0 else 4 * 2 for t in range(MOE_STEPS)]
    assert_update_close(moe4[0]["final"], want, start, "moe m=2")


def test_moe_zo_and_per_worker_codec_keep_the_worker_rows(moe4):
    batches = _moe_batches()
    for out in moe4:
        w = out["worker"]
        assert out["whole"]
        for t, seen in enumerate(out["rows"]):
            whole, mine = batches[t]["tokens"], batches[t]["tokens"][4 * w:4 * w + 4]
            assert seen and all(np.array_equal(r, whole if t % H.TAU == 0 else mine)
                                for r in seen), t
        assert all(np.array_equal(r, batches[0]["tokens"][4 * w:4 * w + 4])
                   for r in out["rows-per_worker"]) and out["rows-per_worker"]
        assert all(np.array_equal(r, batches[0]["tokens"]) for r in out["rows-legacy"])
    assert sorted(out["worker"] for out in moe4) == [0, 0, 1, 1]


def test_dense_fo_on_a_group_is_the_rank_per_worker_step(moe4):
    batch = _moe_batches()[0]
    for out in moe4:
        dense = out["dense"]
        w = out["worker"]
        assert not dense["whole"]
        np.testing.assert_array_equal(dense["rows"], batch["tokens"][4 * w:4 * w + 4])
        assert dense["equal"] and dense["loss_equal"]
