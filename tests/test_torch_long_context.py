"""The sequence-sharded decode of ``long_500k``: ``serve_step`` on caches
whose sequence the worker axes cut (``ShardedParams(..., seq_sharded=True)``,
``init_caches(..., shards=)``), on spawned gloo ranks, against the port's
one process and the JAX reference.

Cases (``torch_dist_helpers.LONG_CASES``, each ``reduced()`` in float32
with every attention layer windowed at ``LONG_W`` = 32 over ``LONG_S`` =
256 rows, as ``config_for_shape`` makes ``long_500k``'s variant):
gemma2-2b and starcoder2-3b (2 KV heads) dense, hymba-1.5b hybrid (its
mamba states whole on every rank of the worker axes), falcon-mamba-7b SSM
(nothing to cut), and hymba-1.5b at 10/5 heads (on model=2 its cache is
cut over ``hd`` too, and read cut: ``attention._hd_decode``).
The caches start from numpy draws (``long_inputs``) and the decode runs at
``LONG_POSITIONS`` in turn: a window straddling the ranks' boundary at row
128 (and the next position, which reads the row the first wrote), one
inside rank 0's rows and the last row.

* **Reference.** One process's ``serve_step`` on the whole cache against
  the JAX ``repro.serving.engine.serve_step`` on the same parameters (the
  reference's ``init_model``, passed over through numpy) and the same
  caches, within rtol 1e-5 / atol 1e-5, the tolerance of
  ``tests/test_torch_transformer.py``.
* **Ranks.** On (data=2), (data=4) and (data=2, model=2): every step's
  logits within rtol 1e-6 and an atol of ``ATOL_REL`` times the largest
  |logit| of one process (the ranks' partial softmaxes are combined and
  normalised after ``P.V``, where one process normalises first; the largest
  difference measured was 1.06e-6 of the largest logit, hymba-1.5b at
  10/5 heads on (data=2, model=2)); every rank's cache
  slice at the end equal to the same rows of one process's, within the
  same bounds; the logits the same bits on every rank.  A rank holds
  ``S / m`` rows of k and v, allocated at that size.
* **Counts.** The combines over the worker axes a step equal the attention
  layers (none for the SSM), each of B·(H/ms)·(hd + 2) float32 on a rank's
  heads, or B·H·(hd/ms + 2) on an ``hd``-cut cache (every head, the rank's
  slice of ``hd``).
* **Controls** that must fail: each rank's softmax normalised on its own
  and the outputs summed without the rescale, and the new row written at
  local row ``pos`` (without the ``- r0`` offset).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as H
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.serving import engine as J
from repro_torch.convert import params_from_numpy
from repro_torch.device import stand_ins
from repro_torch.dist.sharding import ShardedParams, cache_slices, param_specs
from repro_torch.launch import specs
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as T
from torch_dist_helpers import FakeMesh

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-6
#: the atol of a rank's logits against one process, over the largest |logit|
ATOL_REL = 4e-6
MESHES = [(2, 1), (4, 1), (2, 2)]
CASES = [(mesh, case) for mesh in MESHES for case in H.LONG_CASES]


def jconfig(case):
    arch, kw = H.LONG_CASES[case]
    return jget_config(arch).reduced().with_(remat=False, long_context=True, window=H.LONG_W,
                                             **kw)


@pytest.fixture(scope="module")
def ref():
    """case -> (the reference's parameters, their numpy tree)."""
    out = {}
    for case in H.LONG_CASES:
        p = JT.init_model(jax.random.key(0), jconfig(case))
        out[case] = (p, jax.tree.map(np.asarray, p))
    return out


@pytest.fixture(scope="module")
def groups(ref, tmp_path_factory):
    """world -> every rank's ``run_long`` results (groups of 2 and 4)."""
    ref_np = {k: v[1] for k, v in ref.items()}
    return {world: spawn_ranks(H.run_long, world,
                               str(tmp_path_factory.mktemp(f"long{world}") / "init"),
                               ref_np, timeout=420)
            for world in (2, 4)}


@pytest.fixture(scope="module")
def one(ref):
    """case -> the port's one-process ``long_run`` on the whole cache."""
    cache = {}

    def get(case):
        if case not in cache:
            cfg = H.long_config(case)
            cache[case] = H.long_run(cfg, params_from_numpy(ref[case][1], device="cpu"),
                                     *H.long_inputs(cfg))
        return cache[case]
    return get


def atol(one_run):
    return ATOL_REL * max(float(np.abs(x).max()) for x in one_run["logits"])


@pytest.mark.parametrize("case", H.LONG_CASES)
def test_one_process_matches_reference(ref, one, case):
    cfg = H.long_config(case)
    caches, tokens = H.long_inputs(cfg)
    jcaches = {k: jnp.asarray(v) for k, v in caches.items()}
    got = one(case)
    for step, (pos, tok) in enumerate(zip(H.LONG_POSITIONS, tokens)):
        want, jcaches = J.serve_step(jconfig(case), ref[case][0],
                                     jnp.asarray([int(tok)], jnp.int32), jnp.int32(pos), jcaches)
        np.testing.assert_allclose(got["logits"][step], np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
    for name, c in jcaches.items():
        np.testing.assert_allclose(got["caches"][name], np.asarray(c), **TOL, err_msg=name)


@pytest.mark.parametrize("mesh,case", CASES)
def test_ranks_match_one_process(one, groups, mesh, case):
    want = one(case)
    for rank, out in enumerate(groups[mesh[0] * mesh[1]]):
        for step, (got, w) in enumerate(zip(out[(*mesh, case)]["logits"], want["logits"])):
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=atol(want),
                                       err_msg=f"rank {rank} step {step}")


@pytest.mark.parametrize("mesh,case", CASES)
def test_ranks_agree_bit_for_bit(groups, mesh, case):
    outs = [out[(*mesh, case)] for out in groups[mesh[0] * mesh[1]]]
    for out in outs[1:]:
        for got, first in zip(out["logits"], outs[0]["logits"]):
            assert np.array_equal(got, first)


@pytest.mark.parametrize("mesh,case", CASES)
def test_cache_slices_are_one_process_rows(one, groups, mesh, case):
    """Each rank holds ``S / m`` rows of k and v (the whole states), and
    its slice at the end is the same rows of one process's cache."""
    cfg = H.long_config(case)
    want = one(case)
    data, model = mesh
    for rank, out in enumerate(groups[data * model]):
        fake = FakeMesh({"data": rank // model, "model": rank % model}, data=data, model=model)
        cut = cache_slices(cfg, fake, {k: torch.empty(v.shape, device="meta")
                                       for k, v in want["caches"].items()}, seq_sharded=True)
        r = out[(*mesh, case)]
        for name, c in want["caches"].items():
            mine = c[cut[name]]
            assert r["held"][name] == mine.shape, name
            if name in ("k", "v"):
                assert mine.shape[2] == H.LONG_S // data
                assert cut[name][2] == slice(rank // model * H.LONG_S // data,
                                             (rank // model + 1) * H.LONG_S // data)
            np.testing.assert_allclose(r["caches"][name], mine, rtol=RTOL,
                                       atol=ATOL_REL * float(np.abs(c).max()) + 1e-7,
                                       err_msg=name)


@pytest.mark.parametrize("mesh,case", CASES)
def test_combines_a_step_are_the_attention_layers(groups, mesh, case):
    cfg = H.long_config(case)
    if H.hd_cut(cfg, mesh[1]):
        payload = cfg.n_heads * (cfg.head_dim // mesh[1] + 2) * 4     # B = 1
    else:
        payload = cfg.n_heads // mesh[1] * (cfg.head_dim + 2) * 4
    for out in groups[mesh[0] * mesh[1]]:
        for reduces in out[(*mesh, case)]["reduces"]:
            combines = reduces.get(("data",), [0, 0])
            assert combines == ([cfg.n_layers, cfg.n_layers * payload] if cfg.has_attention
                                else [0, 0])
            assert set(reduces) <= {("data",), ("model",)}


@pytest.mark.parametrize("name", ["unscaled", "no-offset"])
def test_control_fails(one, groups, name):
    """Without the rescale to the global max, or with the new row written
    at local row ``pos``, the straddling steps leave the tolerance."""
    want = one("gemma2-2b")
    for out in groups[2]:
        got = out[name]["logits"]
        assert not all(np.allclose(g, w, rtol=RTOL, atol=atol(want))
                       for g, w in zip(got[:2], want["logits"][:2]))


@pytest.mark.parametrize("data,model", MESHES)
def test_init_caches_allocates_a_ranks_rows(data, model):
    """``init_caches`` with a sequence-sharded ``ShardedParams`` makes k and
    v of ``S / m`` rows (and the ``model`` cut), never the whole cache; the
    rows are ``SequenceAxis.rows``."""
    cfg = H.long_config("hymba-1.5b")
    S = 1 << 19
    for rank in range(data * model):
        fake = FakeMesh({"data": rank // model, "model": rank % model}, data=data, model=model)
        like = specs.abstract_params(cfg)
        shards = ShardedParams(param_specs(cfg, like, fake), fake, seq_sharded=True)
        with stand_ins():
            caches = T.init_caches(cfg, 1, S, torch.float32, device="meta", shards=shards)
        kv = cfg.n_kv_heads // model
        assert caches["k"].shape == (cfg.n_layers, 1, S // data, kv, cfg.head_dim)
        assert caches["conv"].shape == (cfg.n_layers, 1, cfg.ssm_conv - 1, cfg.d_inner // model)
        i = rank // model
        assert shards.seq.rows(S) == (i * S // data, (i + 1) * S // data)
        assert shards.seq.axes == ("data",) and shards.seq.size == data
