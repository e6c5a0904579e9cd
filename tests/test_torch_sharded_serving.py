"""Serving on sharded placements: prefill and slot decode partitioned over
``model`` on spawned gloo ranks (``transformer.prefill_at`` /
``decode_step_slots`` / ``init_caches`` and ``serving.Engine`` with
``shards``), against the JAX reference and the port's one process.

Cases (``torch_dist_helpers.SERVE_CASES``, each a ``reduced()`` config in
float32): qwen3-14b with 2 KV heads (its cache cut over KV heads), on the
plain path and on the kernels' dispatch; hymba-1.5b at 4 layers (a windowed
layer; attention and the partitioned mamba mixer, 4 KV heads cut over
heads), with 10/5 heads (5 KV heads do not divide model=2, so the cache is
cut over ``hd`` and read cut, ``attention._hd_decode``; rank 1's query
heads part a group) and with 5/5 heads (``wq`` cut inside a head); falcon-mamba-7b (conv and ssm
states cut over ``d_inner``) on the plain path (the recomputed tail state
on the rank's channels) and on the scan's dispatch; qwen3-moe at model=2
and model=4 (the experts at decode).

* **Reference.** ``prefill_at`` of two right-padded prompts (exact length
  for an SSM): each rank's logits and its slice of every cache leaf
  (``dist.sharding.cache_slices``: ``cache_specs``' cut over ``model``)
  against the JAX ``repro.models.transformer.prefill_at`` on the same
  parameters (the reference's ``init_model``, passed over through numpy),
  within rtol 1e-5 / atol 1e-5, the tolerance of
  ``tests/test_torch_transformer.py``: the frameworks' float32 sums in other
  orders dominate it.
* **One process.** Three ``decode_step_slots`` steps on a 3-slot pool
  (slot 1 inactive) against the port's one-process run on the whole
  parameters: logits within rtol 1e-6 and an atol of ``ATOL_REL[case]``
  times the largest |logit| (a row-parallel product sums float32 partials
  in rank order where one process sums its contraction in one pass; the
  largest difference measured was 1.1e-6 of the largest logit, hymba with
  its ``hd``-cut cache), and the pool at the end within the same bounds.
  The logits are bit for bit the same on every rank.
* **Counts.** The gathers, exchanges and all-reduces over ``model`` of a
  prefill and a decode step equal the hand count of the partitioned layers
  (``torch_dist_helpers.serve_collectives``), and the labelled ones their
  bytes too (``serve_collective_bytes``): the mixer's u and z pieces, the
  logits, and on an ``hd``-cut cache the q, k, v products, the partial
  logits and the attention output, whose gathers are all the decode
  gathers (no weight, no cache).
* **Controls** that must fail: the attention's all-reduce removed (the
  prefill's logits leave the tolerance), and each rank's cache written with
  its KV heads rotated (the cache slices leave the reference's, and the
  decode's logits one process's).
* **Engine.** ``Engine.generate`` on 2 ranks gives one process's greedy
  tokens, on every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as H
from repro.configs import get_config as jget_config
from repro.models import transformer as J
from repro_torch.convert import params_from_numpy
from repro_torch.dist.sharding import cache_slices
from repro_torch.launch.mesh import spawn_ranks
from torch_dist_helpers import FakeMesh

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-6
#: per case: the atol of the logits against one process, over the largest |logit|
ATOL_REL = {"dense": 4e-6, "dense-pallas": 4e-6, "hymba": 4e-6, "hymba-hd": 4e-6,
            "hymba-odd": 4e-6, "falcon-mamba": 2e-6, "falcon-mamba-pallas": 2e-6,
            "qwen3-moe": 4e-6}
MODEL2 = ["dense", "dense-pallas", "hymba", "hymba-hd", "hymba-odd", "falcon-mamba",
          "falcon-mamba-pallas", "qwen3-moe"]
MODEL4 = ["qwen3-moe", "dense"]
GENERATE = ["dense", "hymba-hd", "falcon-mamba"]


def jconfig(case):
    arch, kw = H.SERVE_CASES[case]
    return jget_config(arch).reduced().with_(remat=False, **kw)


@pytest.fixture(scope="module")
def ref():
    """case -> (the reference's parameters, their numpy tree); ``mha``:
    qwen3-14b reduced with its 4 KV heads (the controls' config)."""
    out = {}
    for case in MODEL2:
        p = J.init_model(jax.random.key(0), jconfig(case).with_(use_pallas=False))
        out[case] = (p, jax.tree.map(np.asarray, p))
    p = J.init_model(jax.random.key(0), jconfig("dense").with_(n_kv_heads=4))
    out["mha"] = (p, jax.tree.map(np.asarray, p))
    return out


@pytest.fixture(scope="module")
def two(ref, tmp_path_factory):
    return spawn_ranks(H.run_serving, 2, str(tmp_path_factory.mktemp("serve2") / "init"),
                       {k: v[1] for k, v in ref.items()}, MODEL2, GENERATE, timeout=420)


@pytest.fixture(scope="module")
def four(ref, tmp_path_factory):
    return spawn_ranks(H.run_serving, 4, str(tmp_path_factory.mktemp("serve4") / "init"),
                       {k: ref[k][1] for k in MODEL4}, MODEL4, [], timeout=420)


@pytest.fixture(scope="module")
def one(ref):
    """case -> the port's one-process ``serve_run`` on the whole parameters."""
    cache = {}

    def get(case):
        if case not in cache:
            full = params_from_numpy(ref[case][1], device="cpu")
            cfg = H.serve_config(case) if case != "mha" else \
                H.serve_config("dense").with_(n_kv_heads=4)
            cache[case] = H.serve_run(cfg, full)
        return cache[case]
    return get


def reference_prefill(case, ref):
    """The JAX reference's ``prefill_at`` of ``serve_prompts``: (logits, caches)."""
    cfg = H.serve_config(case) if case != "mha" else H.serve_config("dense").with_(n_kv_heads=4)
    jcfg = jconfig(case) if case != "mha" else jconfig("dense").with_(n_kv_heads=4)
    toks, last = H.serve_prompts(cfg)
    logits, caches = J.prefill_at(jcfg, ref[case][0], {"tokens": jnp.asarray(toks.numpy())},
                                  jnp.asarray(last.numpy()))
    return np.asarray(logits), {k: np.asarray(v) for k, v in caches.items()}


def rank_slices(cfg, caches, rank, world):
    """Each cache leaf's slice on ``rank`` of (data=1, model=world)."""
    mesh = FakeMesh({"data": 0, "model": rank}, data=1, model=world)
    cut = cache_slices(cfg, mesh, {k: torch.empty(v.shape, device="meta")
                                   for k, v in caches.items()})
    return {k: v[cut[k]] for k, v in caches.items()}


def ranks(two, four, world):
    return two if world == 2 else four


@pytest.mark.parametrize("world,case", [(2, c) for c in MODEL2] + [(4, c) for c in MODEL4])
def test_prefill_logits_and_cache_slices_match_reference(ref, two, four, world, case):
    cfg = H.serve_config(case)
    want, caches = reference_prefill(case, ref)
    for rank, out in enumerate(ranks(two, four, world)):
        r = out[case]
        np.testing.assert_allclose(r["logits"][0], want, **TOL)
        mine = rank_slices(cfg, caches, rank, world)
        assert sorted(r["caches"]) == sorted(mine)
        for name, c in mine.items():
            assert r["caches"][name].shape == c.shape, name
            np.testing.assert_allclose(r["caches"][name], c, **TOL, err_msg=name)


@pytest.mark.parametrize("world,case", [(2, c) for c in MODEL2] + [(4, c) for c in MODEL4])
def test_decode_matches_one_process_and_ranks_agree_bit_for_bit(one, two, four, world, case):
    cfg = H.serve_config(case)
    want = one(case)
    outs = ranks(two, four, world)
    atol = ATOL_REL[case] * max(float(np.abs(x).max()) for x in want["logits"])
    for rank, out in enumerate(outs):
        r = out[case]
        for step, (got, w) in enumerate(zip(r["logits"], want["logits"])):
            live = [0, 1] if step == 0 else [0, 2]
            np.testing.assert_allclose(got[live], w[live], rtol=RTOL, atol=atol,
                                       err_msg=f"step {step}")
            assert np.array_equal(got, outs[0][case]["logits"][step])
        mine = rank_slices(cfg, want["pool"], rank, world)
        for name, c in mine.items():
            assert r["held"][name] == c.shape
            np.testing.assert_allclose(r["pool"][name], c, rtol=RTOL,
                                       atol=ATOL_REL[case] * float(np.abs(c).max()) + 1e-7,
                                       err_msg=name)


@pytest.mark.parametrize("world,case", [(2, c) for c in MODEL2] + [(4, c) for c in MODEL4])
def test_collectives_are_the_partitioned_layers(two, four, world, case):
    cfg = H.serve_config(case)
    for rank, out in enumerate(ranks(two, four, world)):
        for kind in ("prefill", "decode"):
            counts = out[case][f"{kind}_counts"]
            gathers, exchanges, reduces = H.serve_collectives(cfg, kind, world)
            assert set(counts["gathers"]) == set(counts["reduces"]) == {("model",)}
            assert counts["gathers"][("model",)][0] == gathers, kind
            assert counts["reduces"][("model",)][0] == reduces, kind
            assert counts["exchanges"].get(("model",), [0, 0])[0] == exchanges, kind
            assert set(counts["exchanges"]) <= {("model",)}
            seq = H.SERVE_LEN + 8 if kind == "decode" else H.SERVE_LEN
            rows = 3 if kind == "decode" else 2
            want = H.serve_collective_bytes(cfg, kind, world, rank, rows, seq)
            assert {k: v for k, v in counts["labels"].items() if k in want} == want, kind
            assert set(counts["labels"]) == set(want), kind
            if kind == "decode" and H.hd_cut(cfg, world):
                # no weight and no cache gathered: every gather is a labelled product
                assert counts["gathers"][("model",)][1] == sum(
                    want[k][1] for k in ("qkv", "attn_out", "logits"))


def test_control_without_the_attention_all_reduce_fails(ref, two):
    want, _ = reference_prefill("mha", ref)
    for out in two:
        got = out["no-attention-reduce"]["logits"][0]
        assert not np.allclose(got, want, **TOL)


def test_control_cache_written_to_the_wrong_kv_heads_fails(ref, one, two):
    cfg = H.serve_config("dense").with_(n_kv_heads=4)
    want, caches = reference_prefill("mha", ref)
    base = one("mha")
    atol = ATOL_REL["dense"] * max(float(np.abs(x).max()) for x in base["logits"])
    for rank, out in enumerate(two):
        r = out["cache-wrong-heads"]
        np.testing.assert_allclose(r["logits"][0], want, **TOL)     # attends its own k, v
        mine = rank_slices(cfg, caches, rank, 2)
        assert not np.allclose(r["caches"]["k"], mine["k"], **TOL)
        assert not all(np.allclose(g[[0, 2]], w[[0, 2]], rtol=RTOL, atol=atol)
                       for g, w in zip(r["logits"][1:], base["logits"][1:]))


@pytest.mark.parametrize("case", GENERATE)
def test_engine_generate_on_two_ranks_gives_one_process_tokens(ref, two, case):
    cfg = H.serve_config(case)
    want = H.serve_generate(cfg, params_from_numpy(ref[case][1], device="cpu"))
    assert all(len(o) == n + 5 for o, n in zip(want, (5, 12, 9)))
    for out in two:
        assert out[f"{case}-generate"] == want


def test_init_caches_hold_the_cache_specs_slices():
    """``init_caches(..., shards=)`` holds each rank's ``cache_specs`` slice:
    k and v cut over KV heads where they divide the axis, else over ``hd``;
    conv and ssm over ``d_inner``; the batch whole on every rank."""
    from repro_torch.dist.sharding import ShardedParams, param_specs
    from repro_torch.models import transformer as T

    for case, world, want in (
            ("dense", 2, {"k": (2, 3, 40, 1, 32)}),
            ("hymba-hd", 2, {"k": (4, 3, 40, 5, 16), "conv": (4, 3, 3, 256),
                             "ssm": (4, 3, 256, 16)}),
            ("falcon-mamba", 4, {"conv": (2, 3, 3, 128), "ssm": (2, 3, 128, 16)}),
            ("qwen3-moe", 4, {"k": (2, 3, 40, 1, 32)})):
        cfg = H.serve_config(case)
        like = T.init_model(0, cfg, device="cpu")
        for rank in range(world):
            mesh = FakeMesh({"data": 0, "model": rank}, data=1, model=world)
            caches = T.init_caches(cfg, 3, 40, torch.float32, device="cpu",
                                   shards=ShardedParams(param_specs(cfg, like, mesh), mesh))
            assert {k: tuple(v.shape) for k, v in caches.items() if k in want} == want
            assert caches["ssm" if cfg.has_ssm else "k"].dtype == torch.float32
