"""The partitioned forward over the ``model`` axis on spawned gloo ranks
(``dist.sharding.ShardedParams``, ``ModelAxis``; the layers of
``models/{layers,attention,moe,ssm,transformer}``).

Tolerances, and why.  A row-parallel product sums float32 partials in rank
order where one process's product sums its contraction in one pass, and the
vocab-parallel cross-entropy combines per-rank carries: in float32 the
losses part by ulps (a few 1e-8 relative) and a gradient by ~1e-6 of its
largest entry.  So losses are held at rtol 1e-6, a parameter update within
2% of the largest update (the process-group rule of
``tests/test_torch_sharded.py``; the ZO coefficient ``(d/mu)(f1 - f0)``
magnifies loss ulps, so a loss rtol alone would pass a wrong step),
gradients within 2e-5 of a leaf's largest |g|, and a step within 2e-5 of
the reference's single-host ``make_ho_sgd`` step (the distributed check's
bound).  Agreement across the ranks of a worker is bit for bit: the
replicated activations, the MoE routing and f0, f1 must be the same on
every rank, or a token could go to different experts on two ranks.

* 2 ranks, (data=1, model=2): qwen3-14b reduced from the reference's
  parameters, an FO step (t=0) and a ZO step (t=5) with m=4 held in the
  process: within 2e-5 of the reference's step and within rtol 1e-6 /
  2% of the update of the port's one-process step, both ranks' loss
  evaluations the same bits, no gather over ``model``, and the all-reduces
  the formula's (``_expected_reduces``).  gemma2-2b reduced (tied
  embedding, 512 words, 256 a rank): the vocab-parallel CE streamed at
  ``ce_chunk`` 96 and 100 (256 not a multiple of either: the last chunk's
  clamp and overlap mask within a rank's columns), dense (-1), and dense on
  a rank while one process streams (300), its loss and every gradient,
  the tied embedding's rows too, against the one-process ones.  A KV = 1
  config (``wk``/``wv`` cut inside their one head): loss and gradients
  against one process, the q, k and v products and the attention output's
  gradient gathered over ``model`` (no weight), calls and bytes.
* 4 ranks: qwen3-moe reduced under fsdp on (data=2, model=2), one worker: a
  ZO and an FO step within 2e-5 of the reference's m=1 steps and within
  rtol 1e-6 / 2% of the update of the one-process ones, the expert ids of
  every route and every loss evaluation the same bits on all four ranks,
  gathers over ``data`` only; ``moe_sharding='expert'`` on (data=1,
  model=4) against one process; qwen3-14b on (data=1, model=4), a ZO step
  the same bits on all four ranks.  Agreement is held on every loss
  evaluation and on a digest of every all-reduce's result (the replicated
  activations, and in an FO step the gradients entering the replicated
  part).
* The mamba mixer partitioned (``models.ssm``): falcon-mamba-7b and
  hymba-1.5b reduced from the reference's parameters on (data=1, model=2)
  and (data=2, model=2), m=2, an FO and a ZO step within 2e-5 of the
  reference's, f0, f1 and the loss within rtol 1e-6 of one process's, the
  update within 2% (or one float32 ulp) of one process's, the ZO step's
  given the same f0 and f1 (``test_mixer_step_matches_reference_and_one_process``
  says why), every all-reduce and loss evaluation the same bits on the
  ranks of a worker, no gather over ``model`` (``in_proj`` stays cut; the
  mixer's exchanges of u and z pieces counted, calls and bytes); the loss
  and gradients on model=2 against one process.
* Controls that must fail: the gemma2 step without the MLP's all-reduce
  (its loss and gradients leave the tolerances); on (data=1, model=4) a
  sum that starts from each rank's own part (the all-reduces' results part
  between the ranks; the losses, means over many terms, may still round
  alike, as they do here); the mixer without its ``out_proj`` all-reduce
  (loss and gradients), and ``conv_w`` sliced without entering (its
  gradient one rank's share, the loss unchanged).
"""
import jax
import numpy as np
import pytest
import torch

import torch_dist_helpers as H
from repro import compat
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import distributed as TD
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves
from test_torch_sharded import (  # noqa: F401  (fixtures: one, qwen, moe)
    _batch, _d, _max_diff, _one_process, _ref, _reference_fo, _reference_zo,
    assert_update_close, moe, one, qwen)

GRAD_REL = 2e-5


@pytest.fixture(autouse=True)
def reference_auto_branch(monkeypatch):
    monkeypatch.setattr(compat, "HAS_PARTIAL_AUTO_COLLECTIVES", False)


@pytest.fixture(scope="module")
def ssm():
    """arch -> the reference's reduced config, parameters and their numpy
    tree, for ``H.SSM_ARCHS``."""
    return {arch: _ref(arch) for arch in H.SSM_ARCHS}


@pytest.fixture(scope="module")
def two(qwen, ssm, tmp_path_factory):
    return spawn_ranks(H.run_partitioned_2, 2, str(tmp_path_factory.mktemp("part2") / "init"),
                       qwen[2], _batch(512), {a: r[2] for a, r in ssm.items()}, timeout=420)


@pytest.fixture(scope="module")
def four(moe, qwen, ssm, tmp_path_factory):
    return spawn_ranks(H.run_partitioned_4, 4, str(tmp_path_factory.mktemp("part4") / "init"),
                       moe[2], qwen[2], _batch(512), {a: r[2] for a, r in ssm.items()},
                       timeout=420)


def _expected_reduces(cfg, kind, evaluations):
    """The partitioned forward's all-reduces in a step: per forward, one
    per attention and one per MLP or MoE sublayer, the embedding's and the
    CE's carries (2L + 2).  An FO step (one microbatch) adds the backward's:
    the CE's entered hidden state, per layer the entered inputs of the
    attention and the MLP (and, with ``qk_norm``, ``q_norm`` and ``k_norm``;
    a MoE layer its gates), and under remat the recomputed sublayers up to
    the last one whose output the backward keeps (non-reentrant checkpoint
    stops there: the MLP's sum is recomputed only under ``post_norms``)."""
    L = cfg.n_layers
    forward = 2 * L + 2
    if kind == "zo":
        return forward * evaluations
    per_layer = 2 + 2 * cfg.qk_norm + cfg.is_moe
    recompute = (1 + cfg.post_norms) * L if cfg.remat else 0
    return forward + 1 + per_layer * L + recompute


def _start(np_tree):
    return [np.asarray(x) for x in jax.tree.leaves(np_tree)]


@pytest.mark.parametrize("kind", ["fo", "zo"])
def test_dense_step_on_model2_matches_reference_and_one_process(qwen, two, one, kind):
    _, _, np_tree = qwen
    cfg, d = get_config("qwen3-14b").reduced(), _d(np_tree)
    r = two[0][kind]
    t = 0 if kind == "fo" else H.ZO_T
    ref = _reference_fo("qwen3-14b", 4) if kind == "fo" else _reference_zo("qwen3-14b", 4)
    assert _max_diff(r["params"], ref) < 2e-5
    p1, loss1, losses1, bytes1 = _one_process(cfg, np_tree, _batch(512), one,
                                              H.llm_config(d, 4), kind, t)
    assert_update_close(r["params"], p1, _start(np_tree), kind)
    np.testing.assert_allclose(r["loss"], loss1, rtol=1e-6)
    np.testing.assert_allclose(r["losses"], losses1, rtol=1e-6)
    assert r["bytes"] == bytes1 == (4 * d if kind == "fo" else 4 * 4)
    assert two[1][kind]["losses"] == r["losses"]            # f0, f1 the same bits
    # every all-reduce's result (the replicated activations and gradients)
    assert two[1][f"{kind}-records"]["sums"] == two[0][f"{kind}-records"]["sums"]


@pytest.mark.parametrize("kind", ["fo", "zo"])
def test_dense_step_makes_no_model_gather_and_the_formulas_all_reduces(two, kind):
    cfg = get_config("qwen3-14b").reduced()
    for out in two:
        r = out[kind]
        assert r["gathers"] == {}
        calls, nbytes = r["reduces"][("model",)]
        assert calls == _expected_reduces(cfg, kind, len(r["losses"]))
        if kind == "zo":
            # per evaluation (2 of the 8 rows, seq 16: T = 32): L float32
            # (T, D) partials twice, the embedding's (T, D) and 3 carries of T
            T, D, L = 32, cfg.d_model, cfg.n_layers
            assert nbytes == len(r["losses"]) * 4 * (2 * L * T * D + T * D + 3 * T)


@pytest.mark.parametrize("chunk", [96, 100, -1, 300])
def test_vocab_parallel_ce_and_tied_embedding_match_one_process(two, chunk):
    for out in two:
        r = out[f"ce{chunk}"]
        np.testing.assert_allclose(r["loss"], r["loss1"], rtol=1e-6)
        assert max(r["grad_rel"].values()) <= GRAD_REL, r["grad_rel"]
        assert r["grad_rel"]["embed"] <= GRAD_REL
        assert r["gathers"] == {}
    assert two[0][f"ce{chunk}"]["loss"] == two[1][f"ce{chunk}"]["loss"]


def test_a_kv_cut_inside_a_head_is_gathered_and_matches(two):
    cfg = get_config("qwen3-14b").reduced().with_(n_kv_heads=1)
    # the q, k and v products gathered a layer, in the forward and in its
    # recompute, and the attention output's gradient in the backward; no
    # weight: every gathered byte is a product's or that gradient's
    want = H.head_cut_gathers(cfg, 4, 16, forwards=2, backwards=1)
    for out in two:
        r = out["kv1"]
        np.testing.assert_allclose(r["loss"], r["loss1"], rtol=1e-6)
        assert max(r["grad_rel"].values()) <= GRAD_REL, r["grad_rel"]
        assert r["labels"] == want
        assert r["gathers"] == {("model",): [7 * cfg.n_layers,
                                             sum(b for _, b in want.values())]}


def test_control_without_the_mlp_all_reduce_fails(two):
    r = two[0]["no-mlp-reduce"]
    assert abs(r["loss"] - r["loss1"]) > 1e-6 * abs(r["loss1"])
    assert max(r["grad_rel"].values()) > GRAD_REL


@pytest.mark.parametrize("kind", ["fo", "zo"])
def test_fsdp_moe_on_data2_model2_matches_reference_and_agrees(moe, four, one, kind):
    _, _, np_tree = moe
    cfg, d = get_config("qwen3-moe-235b-a22b").reduced().with_(fsdp=True), _d(np_tree)
    r = four[0][kind]
    t = 0 if kind == "fo" else H.ZO_T
    ref = (_reference_fo if kind == "fo" else _reference_zo)("qwen3-moe-235b-a22b", 1)
    assert _max_diff(r["params"], ref) < 2e-5
    p1, loss1, losses1, _ = _one_process(cfg, np_tree, _batch(512), one, H.llm_config(d, 1),
                                         kind, t)
    assert_update_close(r["params"], p1, _start(np_tree), kind)
    np.testing.assert_allclose(r["losses"], losses1, rtol=1e-6)
    rec = four[0][f"{kind}-records"]
    assert rec["ids"] and all(len(out[f"{kind}-records"]["ids"]) == len(rec["ids"])
                              for out in four)
    for out in four:
        assert out[kind]["losses"] == r["losses"]
        assert all(np.array_equal(a, b) for a, b in zip(out[f"{kind}-records"]["ids"],
                                                        rec["ids"]))
        assert out[f"{kind}-records"]["sums"] == rec["sums"]
        assert set(out[kind]["gathers"]) == {("data",)}
        assert out[kind]["reduces"][("model",)][0] == _expected_reduces(
            cfg, kind, len(out[kind]["losses"]))


def test_expert_parallel_moe_matches_one_process(four):
    for out in four:
        r = out["expert"]
        np.testing.assert_allclose(r["loss"], r["loss1"], rtol=1e-6)
        assert max(r["grad_rel"].values()) <= GRAD_REL, r["grad_rel"]
        assert r["gathers"] == {}
    assert len({out["expert"]["loss"] for out in four}) == 1


def test_model4_agrees_and_a_rank_order_free_sum_does_not(qwen, four, one):
    _, _, np_tree = qwen
    cfg, d = get_config("qwen3-14b").reduced(), _d(np_tree)
    _, _, losses1, _ = _one_process(cfg, np_tree, _batch(512), one, H.llm_config(d, 4), "zo",
                                    H.ZO_T)
    for out in four:
        assert out["model4"]["losses"] == four[0]["model4"]["losses"]
        assert out["model4-records"]["sums"] == four[0]["model4-records"]["sums"]
        assert out["model4"]["gathers"] == {}
    np.testing.assert_allclose(four[0]["model4"]["losses"], losses1, rtol=1e-6)
    # the control: the replicated activations part between the ranks (the
    # losses, means over many terms, may still round alike)
    assert any(out["model4-rotated-records"]["sums"] != four[0]["model4-rotated-records"]["sums"]
               for out in four)


def assert_update_or_ulp_close(got, want, start, what=""):
    """Every element within 2% of the largest update (``assert_update_close``)
    or one float32 ulp of its value: a ZO update of the SSM archs is the size
    of an ulp of ``A_log``'s largest values (log 16 = 2.77, an ulp 2.4e-7; the
    update at zo_lr = 0.05 / d is 2.7e-7), so a coefficient a few ulps of the
    loss away can round it to the next value; the card's rule is the same
    with a bf16 ulp (``chip_smoke.fo_update_hold``)."""
    scale = max(float(np.abs(w - s).max()) for w, s in zip(want, start))
    assert scale > 0
    for g, w in zip(got, want):
        tol = np.maximum(0.02 * scale + 1e-7, np.spacing(np.abs(w)))
        assert (np.abs(g - w) <= tol).all(), (what, float(np.abs(g - w).max()), scale)


def _one_process_replayed(cfg, np_tree, batch, mesh, ho, t, evals):
    """The port's one-process ZO step whose loss evaluations return
    ``evals`` (another run's f0, f1 of every worker, in order, float32), so
    that its coefficients are that run's: its parameters."""
    full = params_from_numpy(np_tree, device="cpu")
    queue = list(evals)

    def loss(p, b):
        T.loss_fn(cfg, p, b)                      # the same evaluation, its value replaced
        return torch.tensor(queue.pop(0), dtype=torch.float32)

    _, zo = TD.make_distributed_ho_sgd(loss, mesh, ho, model_cfg=cfg, params_like=full)
    p, _, _ = zo(t, full, (), batch)
    assert not queue
    return [x.numpy() for x in tree_leaves(p)]


def _mixer_exchanges(cfg, kind, evaluations):
    """The partitioned mamba mixer's exchanges over ``model`` in a step: one
    of u's and z's pieces a layer a forward, and in an FO step under remat
    once more in the layer's recompute, and once transposed in its
    backward."""
    forward = cfg.n_layers * evaluations
    return forward * (1 + cfg.remat + 1) if kind == "fo" else forward


@pytest.mark.parametrize("mesh", ["model2", "data2-model2"])
@pytest.mark.parametrize("kind", ["fo", "zo"])
@pytest.mark.parametrize("arch", H.SSM_ARCHS)
def test_mixer_step_matches_reference_and_one_process(ssm, two, four, one, arch, kind, mesh):
    """The SSM and hybrid archs, the mixer partitioned (m=2: held in the
    process on model=2, a data rank each on (data=2, model=2)): within
    2e-5 of the reference's step; f0, f1 and the step's loss within rtol
    1e-6 of the port's one-process step's, and the parameters within 2% of
    the update (or one float32 ulp, ``assert_update_or_ulp_close``) of its
    FO step, and of its ZO step given this run's f0 and f1
    (``_one_process_replayed``): the coefficient ``(d/mu)(f1 - f0)`` turns
    the losses' last ulps (rtol 1e-7 here) into tens of percent of a ZO
    update at mu = 1e-3, so the partitioned forward is held by its losses
    and the sharded update by the same coefficients.  The ranks of a worker
    evaluate the same bits, and nothing is gathered over ``model``: the
    mixer's u and z pieces are exchanged (``in_proj`` stays cut)."""
    _, _, np_tree = ssm[arch]
    cfg, d = get_config(arch).reduced(), _d(np_tree)
    t = 0 if kind == "fo" else H.ZO_T
    res = [out[f"{arch}-{kind}"] for out in (two if mesh == "model2" else four)]
    recs = [out[f"{arch}-{kind}-records"] for out in (two if mesh == "model2" else four)]
    ref = (_reference_fo if kind == "fo" else _reference_zo)(arch, 2)
    assert _max_diff(res[0]["params"], ref) < 2e-5
    p1, loss1, losses1, bytes1 = _one_process(cfg, np_tree, _batch(512), one,
                                              H.llm_config(d, 2), kind, t)
    if kind == "zo":
        # the one-process step given this run's f0 and f1 of every worker
        evals = (res[0]["losses"] if mesh == "model2" else
                 [v for w in (0, 1) for v in next(r for r in res if r["worker"] == w)["losses"]])
        p1 = _one_process_replayed(cfg, np_tree, _batch(512), one, H.llm_config(d, 2), t,
                                   evals)
    assert_update_or_ulp_close(res[0]["params"], p1, _start(np_tree), kind)
    assert res[0]["bytes"] == bytes1 == (4 * d if kind == "fo" else 4 * 2)
    for i, (r, rec) in enumerate(zip(res, recs)):
        np.testing.assert_allclose(r["loss"], loss1, rtol=1e-6)
        if kind == "zo" or mesh == "model2":
            # f0, f1 of the worker (every worker's, held in the process)
            want = losses1 if mesh == "model2" else losses1[2 * r["worker"]:2 * r["worker"] + 2]
            np.testing.assert_allclose(r["losses"], want, rtol=1e-6)
        mate = next(j for j, o in enumerate(res) if o["worker"] == r["worker"] and j != i)
        assert r["losses"] == res[mate]["losses"]
        assert rec["sums"] == recs[mate]["sums"]
        # in_proj stays cut: no gather over model; at model=2 a rank
        # receives one piece of u or z, B·S·di/2 float32, a call (a ZO
        # step evaluates each of the m=2 workers held in the process on its
        # half of the rows)
        assert r["gathers"] == {}
        calls, nbytes = r["exchanges"][("model",)]
        assert calls == _mixer_exchanges(cfg, kind, len(r["losses"]))
        tokens = r["rows"].size // (2 if kind == "zo" and mesh == "model2" else 1)
        assert nbytes == calls * 4 * tokens * cfg.d_inner // 2, (calls, nbytes)


@pytest.mark.parametrize("arch", H.SSM_ARCHS)
def test_mixer_gradients_match_one_process_and_controls_fail(two, arch):
    """Loss and every gradient of the partitioned forward within rtol 1e-6
    and 2e-5 of a leaf's largest |g| of one process's; without the mixer's
    ``out_proj`` all-reduce the loss and gradients leave those bounds, and
    with ``conv_w`` sliced but not entered its gradient does (one rank's
    share), while the loss stays."""
    for out in two:
        r = out[f"{arch}-grads"]
        np.testing.assert_allclose(r["loss"], r["loss1"], rtol=1e-6)
        assert max(r["grad_rel"].values()) <= GRAD_REL, r["grad_rel"]
        bad = out[f"{arch}-no-mixer-reduce"]
        assert abs(bad["loss"] - bad["loss1"]) > 1e-6 * abs(bad["loss1"])
        assert max(bad["grad_rel"].values()) > GRAD_REL
        conv = out[f"{arch}-conv-w-not-entered"]
        np.testing.assert_allclose(conv["loss"], conv["loss1"], rtol=1e-6)
        assert conv["grad_rel"]["layers/mamba/conv_w"] > GRAD_REL
        assert max(v for k, v in conv["grad_rel"].items()
                   if k != "layers/mamba/conv_w") <= GRAD_REL
