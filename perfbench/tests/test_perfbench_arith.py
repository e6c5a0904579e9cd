"""Traffic generation and the frozen FLOP, byte and roofline arithmetic (CPU)."""
import json

import numpy as np
import pytest

import tinybench
from harness import flops, manifest, peaks, traffic

BENCH = tinybench.BENCH
SERVE = traffic.load(BENCH / "traffic" / "docs1k-backlog.json")
TRAIN = traffic.load(BENCH / "traffic" / "ho-tau8.json")


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**33 + 5])
def test_serving_mix_is_a_function_of_the_seed(seed):
    a = traffic.serve_requests(SERVE, 65024, seed)
    b = traffic.serve_requests(SERVE, 65024, seed)
    c = traffic.serve_requests(SERVE, 65024, seed + 1)
    assert a == b and a != c
    plen = np.array([len(p) for p, _ in a])
    out = np.array([o for _, o in a])
    assert len(a) == SERVE["requests"]
    assert plen.min() >= 128 and plen.max() <= 1024 and out.min() >= 16 and out.max() <= 64
    assert all(max(p) < 65024 and min(p) >= 0 for p, _ in a)
    for b0 in range(0, len(a), 64):              # one prompt on the kernel's route per 64
        aligned = np.nonzero(plen[b0:b0 + 64] % 64 == 0)[0]
        assert list(aligned) == [0] and plen[b0 + aligned[0]] == 384
    for b0 in range(0, len(a), 16):              # a prompt from (nearly) every slice a block
        block = plen[b0:b0 + 16]
        slices = np.floor(16 * np.log(block / 128) / np.log(8)).astype(int)
        assert len(set(slices)) >= 14


def test_training_batches_are_a_function_of_the_seed():
    a = next(traffic.train_batches(TRAIN, 32001, 2**31 + 3))
    b = next(traffic.train_batches(TRAIN, 32001, 2**31 + 3))
    c = next(traffic.train_batches(TRAIN, 32001, 2**31 + 4))
    assert (a["tokens"] == b["tokens"]).all() and (a["tokens"] != c["tokens"]).any()
    assert a["tokens"].shape == (16, 512)
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).all() and (a["labels"][:, -1] == -1).all()


def test_spread_order_is_a_permutation():
    for n in (4, 16, 7):
        assert sorted(traffic.spread_order(n)) == list(range(n))


def test_attention_pairs_by_hand():
    assert flops.pairs(None, 0, 4) == 1 + 2 + 3 + 4
    assert flops.pairs(2, 0, 4) == 1 + 2 + 2 + 2
    assert flops.pairs(3, 5, 2) == 3 + 3
    assert flops.pairs(None, 10, 1) == 11
    assert flops.pairs(8, 2, 3) == 3 + 4 + 5


def test_forward_flops_by_hand():
    cfg = dict(tinybench.TINY_HYBRID, n_layers=1, layer_pattern="global", d_model=8,
               n_heads=2, n_kv_heads=1, head_dim=4, d_ff=16, vocab_size=10, ssm_state=2,
               dt_rank=2, ssm_expand=2)
    attn = 8 * (2 + 2) * 4 + 2 * 4 * 8                 # q, k, v, o
    mamba = 8 * 32 + 16 * (2 + 4) + 2 * 16 + 16 * 8    # in_proj, x_proj, dt_w, out_proj
    mlp = 3 * 8 * 16
    assert flops.layer_macs(cfg) == attn + mamba + mlp
    pairs = 1 + 2 + 3
    want = 2 * (3 * (attn + mamba + mlp) + pairs * 2 * 2 * 4 + 3 * 8 * 10)
    assert flops.forward(cfg, 0, 3, 3) == want
    assert flops.train_step(cfg, 2, 3, True) == 3 * 2 * want
    assert flops.train_step(cfg, 2, 3, False) == 2 * 2 * want
    ssm = dict(cfg, arch_type="ssm", d_ff=0)
    assert flops.prefill(ssm, 5) == 2 * (5 * mamba + 8 * 10)
    assert flops.decode_token(ssm, 100) == 2 * (mamba + 8 * 10)


def test_published_sizes():
    fm = json.loads((BENCH / "configs" / "falcon-mamba-7b.json").read_text())["model"]
    per_token = flops.decode_token(fm, 0)
    assert per_token == 2 * (64 * (4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096)
                             + 4096 * 65024)


def test_zo_bounds_by_hand():
    d = 10**9
    assert peaks.zo_perturb_bound_s(d) == pytest.approx(8e9 / 3.35e12)
    assert peaks.zo_reconstruct_bound_s(d, 1) == pytest.approx(75e9 / 33.5e12)
    assert peaks.zo_reconstruct_bound_s(100, 4) == pytest.approx(300 * 100 / 33.5e12)


def _read(name, run):
    return manifest.reader(tinybench.REPO, name)(run)


def test_readers_by_hand():
    steps = [{"order": "fo_step", "s": 2.0, "tokens": 100, "finite": True},
             {"order": "zo_step", "s": 1.0, "tokens": 100, "finite": True},
             {"order": "zo_step", "s": 3.0, "tokens": 100, "finite": True}]
    trace = {"busy_s": 4.5, "window_s": 6.0,
             "kernels": {"void perturb_flat_kernel<4>": [0.02, 2], "reconstruct_kernel": [0.01, 2],
                         "other": [4.0, 9]}}
    run = {"kind": "train", "steps": steps, "tokens": 300, "window_s": 6.0, "flops": 989e12 * 0.06,
           "trace": trace, "sumsq_ms": 50.0,
           "zo_bounds_s": {"perturb_flat_kernel": 0.004, "reconstruct_kernel": 0.003}}
    assert _read("train_tokens_per_s", run) == 50.0
    assert _read("mfu", run) == pytest.approx(1.0)
    assert _read("fo_step_ms.train", run) == 2000.0
    assert _read("zo_step_ms.train", run) == 2000.0
    assert _read("zo_sumsq_ms.train", run) == 25.0
    assert _read("device_idle.train", run) == pytest.approx(25.0)
    assert _read("zo_kernels_roofline.train", run) == pytest.approx(100 * 0.014 / 0.03)
    assert _read("device_idle.serve", run) is None
    serve = {"kind": "serve", "prompt_tokens": 900, "generated": 100, "window_s": 4.0,
             "prefills": 3, "n_layers": 64, "scan_launches": 64,
             "prefill_timed": [(0.5, 500), (0.5, 500)], "decode_timed": [(0.1, 0), (0.3, 0)]}
    assert _read("serve_tokens_per_s", serve) == 250.0
    assert _read("prefill_ms_per_ktok.serve", serve) == pytest.approx(1000.0)
    assert _read("decode_step_ms.serve", serve) == pytest.approx(200.0)
    assert _read("scan_route_share.serve", serve) == pytest.approx(100 / 3)
    assert _read("zo_kernels_roofline.train", dict(run, trace=None)) is None
