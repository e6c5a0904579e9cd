"""``repro_torch.launch.dryrun``: one rank's real step on ``meta`` tensors.

* ``run_one`` on the ``--reduce smoke`` configs of gemma2-2b (fo, zo,
  prefill, decode) and qwen3-moe (fo), on one rank and on rank 0 of a fake
  (data=2, model=2) mesh (``REPRO_TEST_MESH``): the record carries the
  reference's keys, the kernels the step called (the flat pair in a ZO
  step), and the collectives are the ``CommLedger``'s booking (4·d FO, 4·m
  ZO) plus the counted gathers; a MoE rank's FO step computes the global
  batch (the same flops on one rank and on four), a dense rank's its
  worker's rows (half).
* ``cost.flops`` of a 1-layer prefill equals the hand count of its matrix
  products (flash attention's 4·hd per live pair and head).
* The twin: the same FO step on real CPU tensors in 4 spawned gloo ranks
  (``tests/torch_dist_helpers.run_dry_twin``): rank 0's gathers, gathered
  bytes and ledger bytes equal the dry run's, and the ``Meter``'s peak and
  arguments over the real step equal the dry run's over the meta one.
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
    if step == "fo":
        assert rec["kernels"] == {}
        assert coll["all-reduce"] == coll["axis_worker"] == _d_bytes(arch)
    if step == "zo":
        assert rec["kernels"] == {"zo_perturb_flat": 1, "zo_reconstruct_flat": 1}
        assert coll["all-gather"] - coll["axis_model"] == coll["axis_worker"] == 4 * m
    if step in ("fo", "zo"):
        assert (coll["axis_model"] > 0) == (mesh == "2x2")
        assert rec["workers"] == m
    if step in ("prefill", "decode"):
        # gemma2's windows differ by layer: its attention takes the plain path
        assert rec["kernels"] == {} and coll["total"] == 0


def test_a_moe_rank_takes_the_global_batch(monkeypatch):
    flops = {}
    for arch in ("gemma2-2b", "qwen3-moe-235b-a22b"):
        for mesh in ("1x1", "2x2"):
            monkeypatch.setenv("REPRO_TEST_MESH", mesh)
            rec = dryrun.run_one(arch, SMALL["train"], False, "fo", verbose=False,
                                 reduce="smoke")
            flops[arch, mesh] = rec["cost"]["flops"]
    assert flops["gemma2-2b", "2x2"] * 2 == flops["gemma2-2b", "1x1"]
    assert flops["qwen3-moe-235b-a22b", "2x2"] == flops["qwen3-moe-235b-a22b", "1x1"]


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
    assert {"+".join(k): n for k, (n, _) in real["gathers"].items()} == rec["gathers"]
    assert sum(b for _, b in real["gathers"].values()) == rec["collectives"]["axis_model"]
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
