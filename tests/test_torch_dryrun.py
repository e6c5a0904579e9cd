"""``repro_torch.launch.dryrun``: one rank's real step on ``meta`` tensors.

* ``run_one`` on the ``--reduce smoke`` configs of gemma2-2b (fo, zo,
  prefill, decode) and qwen3-moe (fo), on one rank and on rank 0 of a fake
  (data=2, model=2) mesh (``REPRO_TEST_MESH``): the record carries the
  reference's keys, the kernels the step called (the flat pair in a ZO
  step), and the collectives are the ``CommLedger``'s booking (4·d FO, 4·m
  ZO) plus the counted gathers and the partitioned forward's all-reduces
  (on ``model``: no gather there for these dense and MoE layers); a MoE
  rank's FO step computes the global batch (the same flops on the (data=1,
  model=2) mesh and on (data=2, model=2)), a dense rank's its worker's rows
  (half of them there; a quarter of one rank's flops on (2, 2), every
  product partitioned over ``model``).
* ``cost.flops`` of a 1-layer prefill equals the hand count of its matrix
  products (flash attention's 4·hd per live pair and head).
* The twin: the same FO step on real CPU tensors in 4 spawned gloo ranks
  (``tests/torch_dist_helpers.run_dry_twin``): rank 0's gathers and
  all-reduces, their bytes and the ledger bytes equal the dry run's, and the ``Meter``'s peak and
  arguments over the real step equal the dry run's over the meta one.
* The serving targets on (data=1, model=2): a rank's arguments are its
  parameter shards and its ``cache_specs`` cache slices, its collectives
  the partitioned layers' hand count; ``long_500k`` on (data=2, model=2)
  prices the rank's shards and ``S / 2`` rows of k and v, and one combine
  a layer over the worker axes.
* ``all_reduce_sum`` on the ``fake`` group peaks at ``x``, one float32
  accumulator and one received part, not every rank's parts.
* ``main --all`` over a reduced matrix (two archs, small shapes) exits 0,
  writes one JSON a target, resumes done targets and exits 1 on a failure.
"""
import json
import os

import numpy as np
import pytest

import torch_dist_helpers as H
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import fake
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn_ranks

REF_KEYS = {"arch", "shape", "mesh", "step", "applicable", "skip_reason", "n_layers", "period",
            "n_groups", "params", "params_active", "model_flops", "cost", "memory",
            "collectives", "kernels", "run_s"}
COLL_KEYS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
             "axis_model", "axis_worker", "axis_unknown", "total"}
MEM_KEYS = {"argument_size_in_bytes", "peak_memory_in_bytes", "temp_size_in_bytes",
            "output_size_in_bytes"}
SMALL = {"train": ShapeConfig("train_small", 64, 8, "train"),
         "prefill": ShapeConfig("prefill_small", 128, 4, "prefill"),
         "decode": ShapeConfig("decode_small", 256, 4, "decode")}
TARGETS = [("gemma2-2b", "fo"), ("gemma2-2b", "zo"), ("gemma2-2b", "prefill"),
           ("gemma2-2b", "decode"), ("qwen3-moe-235b-a22b", "fo")]


def _shape(step):
    return SMALL["train" if step in ("fo", "zo") else step]


def _d_bytes(arch):
    cfg = get_config(arch).reduced()
    from repro_torch.launch import specs
    from repro_torch.tree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(specs.abstract_params(cfg)))


@pytest.mark.parametrize("mesh", ["1x1", "2x2"])
@pytest.mark.parametrize("arch,step", TARGETS)
def test_run_one_on_smoke_configs(arch, step, mesh, monkeypatch):
    monkeypatch.setenv("REPRO_TEST_MESH", mesh)
    rec = dryrun.run_one(arch, _shape(step), False, step, verbose=False, reduce="smoke")
    assert REF_KEYS <= set(rec) and COLL_KEYS == set(rec["collectives"])
    assert MEM_KEYS == set(rec["memory"]) and set(rec["cost"]) == {"flops", "bytes"}
    mem, coll = rec["memory"], rec["collectives"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["peak_memory_in_bytes"]
    assert mem["temp_size_in_bytes"] == mem["peak_memory_in_bytes"] - mem["argument_size_in_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert coll["total"] == sum(coll[k] for k in
                                ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                 "collective-permute"))
    m = 1 if mesh == "1x1" else 2
    reduced = sum(rec["reduce_bytes"].values())
    if step == "fo":
        assert rec["kernels"] == {}
        assert coll["all-reduce"] - reduced == coll["axis_worker"] == _d_bytes(arch)
    if step == "zo":
        assert rec["kernels"] == {"zo_perturb_flat": 1, "zo_reconstruct_flat": 1}
        assert coll["all-gather"] == coll["axis_worker"] == 4 * m
    if step in ("fo", "zo"):
        assert "model" not in rec["gathers"]
        assert (coll["axis_model"] > 0) == (reduced > 0) == (mesh == "2x2")
        assert coll["axis_model"] == rec["reduce_bytes"].get("model", 0)
        assert rec["workers"] == m
    if step in ("prefill", "decode"):
        # gemma2's windows differ by layer: its attention takes the plain path
        assert rec["kernels"] == {}
        # on (2, 2) partitioned over model: every collective is the layers'
        assert coll["total"] == coll["axis_model"] == (
            sum(rec["reduce_bytes"].values()) + sum(rec["gather_bytes"].values()))
        assert (coll["total"] > 0) == (mesh == "2x2")


#: serving configs on (data=1, model=2): KV heads cut (qwen3-14b), ``hd`` cut
#: (hymba-1.5b with 5 KV heads), d_inner cut (falcon-mamba-7b), experts
SERVE_TARGETS = [("qwen3-14b", {}), ("hymba-1.5b", {"n_heads": 10, "n_kv_heads": 5}),
                 ("falcon-mamba-7b", {}), ("qwen3-moe-235b-a22b", {})]


def _rounded(n):
    return -(-n // dryrun.ALLOC_ROUND) * dryrun.ALLOC_ROUND


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch,kw", SERVE_TARGETS)
def test_serving_targets_price_a_ranks_shards_and_cache_slices(arch, kw, step, monkeypatch):
    """On rank 0 of (data=1, model=2) the serving targets' arguments are
    the rank's parameter shards (``param_specs`` cut through
    ``shard_slices``) plus, at decode, its slices of the caches
    (``cache_specs``' cut over ``model``) and the tokens, at prefill the
    prompt; each storage rounded to the allocator's 512 bytes.  The
    collectives are the partitioned layers' hand count
    (``torch_dist_helpers.serve_collectives``), all on ``model``, and the
    labelled ones' bytes ``serve_collective_bytes``' (``named``): on the
    ``hd``-cut cache no cache is gathered."""
    import math

    import torch

    from repro_torch.configs import config_for_shape
    from repro_torch.dist.sharding import cache_specs, param_specs, shard_slices
    from repro_torch.launch import specs
    from repro_torch.tree import tree_leaves

    monkeypatch.setenv("REPRO_TEST_MESH", "1x2")
    cfg = get_config(arch).reduced().with_(**kw)
    shape = _shape(step)
    rec = dryrun.run_one(arch, shape, False, step, verbose=False, cfg=cfg)
    mesh = H.FakeMesh({"data": 0, "model": 0}, data=1, model=2)
    sizes, coord = {"data": 1, "model": 2}, {"data": 0, "model": 0}
    run_cfg = config_for_shape(cfg, shape).with_(use_pallas=True)
    like = specs.abstract_params(run_cfg)
    pspecs = param_specs(run_cfg, like, mesh)
    want = sum(_rounded(math.prod(sl.stop - sl.start for sl in shard_slices(
        sp, x.shape, sizes, coord)) * x.element_size())
        for sp, x in zip(tree_leaves(pspecs), tree_leaves(like)))
    if step == "decode":
        _, _, caches = specs.decode_structs(run_cfg, shape)
        cspecs = cache_specs(run_cfg, mesh, caches)
        want += sum(_rounded(math.prod(sl.stop - sl.start for sl in shard_slices(
            cspecs[k], x.shape, sizes, coord)) * x.element_size()) for k, x in caches.items())
        want += _rounded(shape.global_batch * 4)                  # the tokens
    else:
        want += _rounded(shape.global_batch * shape.seq_len * 4)  # the prompt
    assert rec["memory"]["argument_size_in_bytes"] == want
    whole = sum(_rounded(x.numel() * x.element_size()) for x in tree_leaves(like))
    assert want < whole
    gathers, exchanges, reduces = H.serve_collectives(run_cfg, step, 2)
    assert (rec["gathers"], rec["reduces"]) == ({"model": gathers}, {"model": reduces})
    assert rec["exchanges"] == ({"model": exchanges} if exchanges else {})
    assert rec["collectives"]["total"] == rec["collectives"]["axis_model"] > 0
    assert rec["collectives"]["collective-permute"] == sum(rec["exchange_bytes"].values())
    B, S = shape.global_batch, shape.seq_len
    named = H.serve_collective_bytes(run_cfg, step, 2, 0, B, S)
    assert rec["named"] == named
    if arch == "hymba-1.5b" and step == "decode":
        # the hd-cut caches stay cut: every gather is a product or the
        # logits, far less than the layers' k and v caches
        L = run_cfg.n_layers
        cache = 2 * L * B * S * run_cfg.n_kv_heads * run_cfg.head_dim * 4
        assert rec["gather_bytes"]["model"] == sum(
            named[k][1] for k in ("qkv", "attn_out", "logits")) < cache
    assert torch.float32 == getattr(torch, run_cfg.dtype)


@pytest.mark.parametrize("arch", ["gemma2-2b", "hymba-1.5b", "falcon-mamba-7b"])
def test_long_500k_decode_cuts_the_sequence_over_the_workers(arch, monkeypatch):
    """``long_500k`` on rank 0 of (data=2, model=2): the rank's arguments
    are its parameter shards, ``S / 2`` rows of k and v cut over ``model``
    too (``cache_specs(..., seq_sharded=True)``: the sequence over the
    worker axes), its ``model`` slice of the whole SSM states, and the
    token; each attention layer combines the ranks' partial softmaxes once
    over the worker axes (B·H/2·(hd + 2) float32, on ``axis_worker``)."""
    import math

    from repro_torch.configs import SHAPES, config_for_shape
    from repro_torch.dist.sharding import cache_specs, param_specs, shard_slices
    from repro_torch.launch import specs
    from repro_torch.tree import tree_leaves

    monkeypatch.setenv("REPRO_TEST_MESH", "2x2")
    cfg = get_config(arch).reduced()
    rec = dryrun.run_one(arch, "long_500k", False, "decode", verbose=False, cfg=cfg)
    shape = SHAPES["long_500k"]
    run_cfg = config_for_shape(cfg, shape).with_(use_pallas=True)
    mesh = H.FakeMesh({"data": 0, "model": 0}, data=2, model=2)
    sizes, coord = {"data": 2, "model": 2}, {"data": 0, "model": 0}
    like = specs.abstract_params(run_cfg)
    want = sum(_rounded(math.prod(sl.stop - sl.start for sl in shard_slices(
        sp, x.shape, sizes, coord)) * x.element_size())
        for sp, x in zip(tree_leaves(param_specs(run_cfg, like, mesh)), tree_leaves(like)))
    _, _, caches = specs.decode_structs(run_cfg, shape)
    cspecs = cache_specs(run_cfg, mesh, caches, seq_sharded=True)
    S, L = shape.seq_len, run_cfg.n_layers
    for name, x in caches.items():
        cut = shard_slices(cspecs[name], x.shape, sizes, coord)
        if name in ("k", "v"):
            assert cut[2] == slice(0, S // 2) and cspecs[name][2] == ("data",)
        else:
            assert cut[1] == slice(0, 1)
        want += _rounded(math.prod(sl.stop - sl.start for sl in cut) * x.element_size())
    want += _rounded(4)                                            # the token
    assert rec["memory"]["argument_size_in_bytes"] == want
    combine = run_cfg.n_heads // 2 * (run_cfg.head_dim + 2) * 4
    if run_cfg.has_attention:
        assert (rec["reduces"]["data"], rec["reduce_bytes"]["data"]) == (L, L * combine)
        assert rec["collectives"]["axis_worker"] == L * combine
    else:
        assert "data" not in rec["reduces"] and rec["collectives"]["axis_worker"] == 0
    assert rec["collectives"]["axis_model"] > 0


def test_all_reduce_sum_holds_one_part_at_a_time():
    """On the dry run's ``fake`` group over meta tensors, ``all_reduce_sum``
    of a float32 ``x`` over 16 ranks peaks at ``x`` plus the float32
    accumulator plus one received part (the bf16 result is rounded after
    the part is freed), not the 16 ranks' parts at once; its ``REDUCES``
    booking is one call at ``x``'s bytes."""
    import torch

    from repro_torch.dist import collectives as coll
    from repro_torch.launch.mesh import make_test_mesh

    from repro_torch.device import stand_ins

    n = 1 << 20
    with dryrun.fake_group(16), stand_ins():
        mesh = make_test_mesh(data=1, model=16, device="meta")
        for dtype, extra in ((torch.float32, 4 * n + 4 * n), (torch.bfloat16, 4 * n + 2 * n)):
            coll.reset_gathers()
            meter = dryrun.Meter()
            with meter:
                x = torch.empty(n, dtype=dtype, device="meta")
                held = meter.live
                out = coll.all_reduce_sum(x, "model", mesh=mesh)
            assert out.shape == x.shape and out.dtype == dtype
            assert meter.peak - held == extra
            assert coll.REDUCES == {("model",): [1, n * x.element_size()]}


def test_a_moe_rank_takes_the_global_batch(monkeypatch):
    flops = {}
    for arch in ("gemma2-2b", "qwen3-moe-235b-a22b"):
        for mesh in ("1x1", "1x2", "2x2"):
            monkeypatch.setenv("REPRO_TEST_MESH", mesh)
            rec = dryrun.run_one(arch, SMALL["train"], False, "fo", verbose=False,
                                 reduce="smoke")
            flops[arch, mesh] = rec["cost"]["flops"]
    assert flops["gemma2-2b", "2x2"] * 2 == flops["gemma2-2b", "1x2"]
    assert flops["gemma2-2b", "2x2"] * 4 == flops["gemma2-2b", "1x1"]
    assert flops["qwen3-moe-235b-a22b", "2x2"] == flops["qwen3-moe-235b-a22b", "1x2"]


def test_flops_of_a_one_layer_prefill_are_its_matrix_products(monkeypatch):
    monkeypatch.setenv("REPRO_TEST_MESH", "1x1")
    cfg = get_config("qwen3-14b").reduced().with_(n_layers=1)
    B, S = 2, 128
    rec = dryrun.run_one("qwen3-14b", ShapeConfig("p", S, B, "prefill"), False, "prefill",
                         verbose=False, cfg=cfg)
    D, H, KV, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                          cfg.vocab_size)
    T = B * S
    want = (2 * T * D * (H + 2 * KV) * hd      # q, k, v
            + 2 * T * H * hd * D                # wo
            + 3 * 2 * T * D * F                 # swiglu: gate, up, down
            + 4 * hd * H * B * S * (S + 1) // 2  # flash: causal pairs
            + 2 * B * D * V)                    # the last position's logits
    assert rec["kernels"] == {"flash_attention": 1}
    assert rec["cost"]["flops"] == want
    assert dryrun.live_pairs(S, S, True, None) == S * (S + 1) // 2
    assert dryrun.live_pairs(4, 6, True, 2) == 1 + 2 + 2 + 2
    assert dryrun.live_pairs(4, 6, False, 2) == 6 + 6 + 5 + 4
    assert dryrun.live_pairs(3, 5, False, None) == 15 and dryrun.live_pairs(5, 3, True, None) == 12


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (8, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    return spawn_ranks(H.run_dry_twin, 4, str(tmp_path_factory.mktemp("twin") / "init"),
                       batch, timeout=300)


@pytest.mark.parametrize("step", ["fo", "zo"])
def test_dry_run_matches_the_real_step(twin, step, monkeypatch):
    monkeypatch.setenv("REPRO_TEST_MESH", "2x2")
    rec = dryrun.run_one("gemma2-2b", SMALL["train"], False, step, verbose=False,
                         reduce="smoke")
    real = twin[0][step]
    for kind in ("gathers", "reduces"):
        assert {"+".join(k): n for k, (n, _) in real[kind].items()} == rec[kind]
    assert rec["reduces"]["model"] > 0
    assert sum(b for kind in ("gathers", "reduces") for axes, (_, b) in real[kind].items()
               if axes == ("model",)) == rec["collectives"]["axis_model"]
    assert sum(b for _, b in real["ledger"]) == rec["collectives"]["axis_worker"]
    assert real["arguments"] == rec["memory"]["argument_size_in_bytes"]
    if step == "fo":                    # no kernel: the same operations on both
        assert real["peak"] == rec["memory"]["peak_memory_in_bytes"]


def test_main_all_over_a_reduced_matrix(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TEST_MESH", "1x1")
    monkeypatch.setattr(dryrun, "ARCH_IDS", ["gemma2-2b", "hubert-xlarge"])
    monkeypatch.setattr(dryrun, "SHAPES", {"train_4k": SMALL["train"],
                                           "decode_32k": SMALL["decode"]})
    out = str(tmp_path / "dry")
    dryrun.main(["--all", "--reduce", "smoke", "--out", out])
    files = sorted(os.listdir(out))
    assert files == ["gemma2-2b__decode_32k__pod__decode.json",
                     "gemma2-2b__train_4k__pod__fo.json", "gemma2-2b__train_4k__pod__zo.json",
                     "hubert-xlarge__decode_32k__pod__decode.json",
                     "hubert-xlarge__train_4k__pod__fo.json",
                     "hubert-xlarge__train_4k__pod__zo.json"]
    with open(os.path.join(out, "hubert-xlarge__decode_32k__pod__decode.json")) as f:
        assert not json.load(f)["applicable"]       # encoder-only: no decode
    assert "5 ok, 1 skipped, 0 FAILED" in capsys.readouterr().out
    dryrun.main(["--all", "--reduce", "smoke", "--out", out])
    assert capsys.readouterr().out.count("[resume]") == 6

    def broken(*a, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "run_one", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma2-2b", "--shape", "train_4k", "--force", "--out", out])
    assert e.value.code == 1
    with open(os.path.join(out, "gemma2-2b__train_4k__pod__fo.json")) as f:
        assert json.load(f)["error"] == "RuntimeError: boom"


def test_fake_calls_count_only_stand_in_calls():
    import torch

    from repro_torch.kernels import ops

    fake.reset_calls()
    ops.reset_launch_counts()
    x = torch.zeros(4096)
    salts = torch.zeros(1, dtype=torch.int64).to(torch.uint32)
    ctrs = torch.zeros(1, dtype=torch.int64).to(torch.uint32)
    nvalid = torch.full((1,), 4096, dtype=torch.int32)
    ops.zo_perturb_flat(x, salts, ctrs, nvalid, 1e-3)            # plain version
    assert fake.CALLS["zo_perturb_flat"] == 0
    ops.zo_perturb_flat(x.to("meta"), salts.to("meta"), ctrs.to("meta"), nvalid.to("meta"), 1e-3)
    assert fake.CALLS["zo_perturb_flat"] == 1
    assert sum(ops.launch_counts().values()) == 0
