"""The partitioned layers keep ``in_proj`` and an ``hd``-cut KV cache cut, as
the reference does, and exchange activations in their place
(``dist.collectives.exchange``, ``models.ssm._rank_uz``,
``models.attention._hd_decode``), on spawned gloo ranks in float32.

* **The exchange.** On 2 and 4 ranks (``torch_dist_helpers.exchange_plans``:
  the mixer's u/z plan, and a plan of pieces of several lengths on dim 1,
  from the rank itself, twice from one source, and on 4 ranks a rank that
  takes only its own piece), each rank's pieces are exactly its planned slices of the
  sources' tensors, bit for bit, and the bytes it books are those of the
  pieces it received from other ranks; ``ModelAxis.exchange``'s backward
  gives each rank the sum of its pieces' gradients at their slices (the
  transposed exchange, booked the same way), to float32 rounding of that
  sum.
* **The mixer** (``in_proj`` kept cut): falcon-mamba-7b and hymba-1.5b
  reduced on (model=2), (model=4) and (data=2, model=2): the loss and every
  gradient within rtol 1e-6 and ``GRAD_REL`` (2e-5) of a leaf's largest
  |g| of one process's (tighter than the 2%-of-the-update rule), the
  rank's ``in_proj`` gradient its own columns of one process's, with no
  gather over ``model`` at all and the exchanges of a forward and its
  backward counted; on model=4 FO and ZO steps within 2e-5 of the
  reference's ``make_ho_sgd`` and within the process-group rules of one
  process (``test_torch_partitioned.py`` holds model=2 and (data=2,
  model=2)).  Serving on model=2 and model=4: prefill logits within rtol
  1e-5 / atol 1e-5 of the JAX ``prefill_at``, three slot decode steps
  within rtol 1e-6 and ``ATOL_REL`` times the largest |logit| of one
  process's (the rule of ``tests/test_torch_sharded_serving.py``), every
  rank the same bits, and the only gathers the logits' (and on the hybrid
  the products of an ``hd``-cut decode, below).
* **Decode on an ``hd``-cut cache**: hymba-1.5b reduced at 10/5 heads
  (``hymba-hd``), at 5/5 (``hymba-odd``, ``wq`` cut inside a head at
  model=2) and at 10/5 with ``attn_softcap=50.0`` (``hymba-hd-cap``), on
  model=2 and model=4: three slot decode steps and three scalar
  ``serve_step``s (``scalar_run``) within rtol 1e-6 and ``ATOL_REL`` times
  the largest |logit| of one process's, every rank the same bits, one
  process's scalar steps within rtol 1e-5 / atol 1e-5 of the JAX
  ``serve_step`` on the reference's caches; the decode's gathers are the q,
  k, v products, the attention output and the logits, to the byte: no cache
  and no weight crosses ranks (cache-gather bytes 0), and the partial
  logits are one all-reduce a layer.
* **Attention cut inside a head** (the training forward and prefill gather
  the q, k and v products, not ``wq``/``wk``/``wv``): hymba-1.5b's
  attention at full width (25/5 heads, hd 64) on model=2, B=2, S=64, from
  the JAX ``init_attention``'s parameters: the forward, prefill and the
  gradient of the forward's sum within rtol 1e-5 / atol 1e-5 of the JAX
  ``attention_forward``, ``attention_prefill`` and ``jax.grad`` and within
  ``GRAD_REL`` of one process's, each rank's cache its ``hd`` slice of the
  reference's; the collectives, by kind and shape, those that
  ``tests/helpers/reference_collectives.py`` reads from the reference's
  compiled programs on a (1, 2) CPU mesh (run in a subprocess), and no
  weight gathered or all-reduced (the bytes of every gather and all-reduce
  accounted for by the products, the output's gradient and x's).  The
  ``HEAD_CUT`` configs (hymba at 10/5 and 5/5 heads, qwen3-14b with one KV
  head) on model=2 and model=4: loss and gradients against one process,
  the gathers over ``model`` the products' and the output gradient's to
  the byte (``torch_dist_helpers.head_cut_gathers``).
* **Controls** that must fail: the mixer's exchange with u's and z's
  sources swapped (the served logits leave one process's and the JAX
  reference's, and the loss and gradients leave one process's); each
  rank's partial logits scaled and soft-capped before the sum, and the
  summed logits scaled by ``sqrt(hd/ms)`` (the decode's logits leave one
  process's); ``ModelAxis.split`` whose backward only slices (the
  attention's gradients leave one process's).
The same-card exchange and its transpose are held on the card by
``tests/test_torch_gpu.py::test_exchange_between_ranks_on_one_card``.

Alone: ``PYTHONPATH=src:tests JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_kept_cut.py`` (one group of 2 and one of 4 spawned ranks).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as H
from repro import compat
from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import spawn_ranks
from test_torch_partitioned import (  # noqa: F401  (fixtures: one, ssm)
    GRAD_REL, _mixer_exchanges, _one_process_replayed, _start, assert_update_or_ulp_close,
    ssm)
from test_torch_sharded import (  # noqa: F401
    _batch, _d, _max_diff, _one_process, _reference_fo, _reference_zo, one)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-6
#: the logits' atol against one process over the largest |logit|: the rule
#: of tests/test_torch_sharded_serving.py (hymba's and falcon-mamba's there)
ATOL_REL = {"falcon-mamba": 2e-6, "hymba": 4e-6, "hymba-hd": 4e-6, "hymba-odd": 4e-6,
            "hymba-hd-cap": 4e-6}
SERVED = H.KEPT_MIXER + H.KEPT_HD
MESHES = [("1x2", 2), ("1x4", 4), ("2x2", 4)]


@pytest.fixture(autouse=True)
def reference_auto_branch(monkeypatch):
    monkeypatch.setattr(compat, "HAS_PARTIAL_AUTO_COLLECTIVES", False)


def jconfig(case):
    arch, kw = H.SERVE_CASES[case]
    return jget_config(arch).reduced().with_(remat=False, **kw)


@pytest.fixture(scope="module")
def ref():
    """case -> (the reference's parameters, their numpy tree)."""
    out = {}
    for case in SERVED:
        p = JT.init_model(jax.random.key(0), jconfig(case).with_(use_pallas=False))
        out[case] = (p, jax.tree.map(np.asarray, p))
    return out


@pytest.fixture(scope="module")
def attn():
    """hymba-1.5b's attention at full width: the JAX ``init_attention``'s
    float32 parameters and x (B=2, S=64, a numpy draw), as numpy."""
    cfg = jget_config("hymba-1.5b")
    p = JA.init_attention(jax.random.key(0), cfg, jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    return jax.tree.map(np.asarray, p), x


@pytest.fixture(scope="module")
def groups(ssm, ref, attn, tmp_path_factory):
    """world -> every rank's ``run_kept_cut``."""
    args = ({a: r[2] for a, r in ssm.items()}, _batch(512), {k: v[1] for k, v in ref.items()},
            attn)
    return {world: spawn_ranks(H.run_kept_cut, world,
                               str(tmp_path_factory.mktemp(f"kept{world}") / "init"), *args,
                               timeout=600)
            for world in (2, 4)}


@pytest.fixture(scope="module")
def served_one(ref):
    """case -> the port's one-process ``serve_run`` and ``scalar_run``."""
    cache = {}

    def get(case):
        if case not in cache:
            cfg, full = H.serve_config(case), params_from_numpy(ref[case][1], device="cpu")
            cache[case] = (H.serve_run(cfg, full),
                           H.scalar_run(cfg, full) if case in H.KEPT_HD else None)
        return cache[case]
    return get


def _atol(case, logits):
    return ATOL_REL[case] * max(float(np.abs(x).max()) for x in logits)


# --------------------------------------------------------------------------- #
# the exchange
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["uz", "mixed"])
def test_exchange_moves_exactly_the_planned_slices(groups, world, name):
    plan, shape, dim = H.exchange_plans(world)[name]
    xs = [H.exchange_inputs(r, shape, plan)[0] for r in range(world)]
    key = f"1x{world}"
    for rank, out in enumerate(groups[world]):
        r = out[key, "exchange"][name]
        assert len(r["pieces"]) == len(plan[rank])
        received = 0
        for got, (src, start, length) in zip(r["pieces"], plan[rank]):
            want = np.take(xs[src], np.arange(start, start + length), axis=dim)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            received += got.nbytes * (src != rank)
        assert r["same"]                   # ModelAxis.exchange: the same pieces
        ex = r["counts"]["exchanges"]
        assert ex == {("model",): [1, received]}
        assert r["counts"]["labels"] == {name: [1, received]}
        assert r["counts"]["gathers"] == r["counts"]["reduces"] == {}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["uz", "mixed"])
def test_exchange_backward_returns_each_pieces_gradient_to_its_owner(groups, world, name):
    plan, shape, dim = H.exchange_plans(world)[name]
    key = f"1x{world}"
    want = [np.zeros(shape, np.float32) for _ in range(world)]
    sent = [0] * world
    for d in range(world):
        _, ws = H.exchange_inputs(d, shape, plan)
        for w, (src, start, length) in zip(ws, plan[d]):
            piece = list(shape)
            piece[dim] = length
            idx = [slice(None)] * len(shape)
            idx[dim] = slice(start, start + length)
            want[src][tuple(idx)] += np.resize(w, piece)
            sent[src] += (src != d) * int(np.prod(piece)) * 4
    for rank, out in enumerate(groups[world]):
        r = out[key, "exchange"][name]
        np.testing.assert_allclose(r["grad"], want[rank], rtol=1e-6, atol=1e-6)
        # the transpose books the gradients this rank received: its pieces' owners'
        assert r["grad_counts"]["exchanges"] == {("model",): [1, sent[rank]]}
        assert r["grad_counts"]["labels"] == {f"{name}_grad": [1, sent[rank]]}
        assert r["grad_counts"]["gathers"] == r["grad_counts"]["reduces"] == {}


# --------------------------------------------------------------------------- #
# the mixer: in_proj kept cut
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh,world", MESHES)
@pytest.mark.parametrize("arch", H.SSM_ARCHS)
def test_mixer_loss_and_gradients_match_one_process_without_a_model_gather(
        groups, arch, mesh, world):
    """Every leaf's gradient, ``in_proj``'s columns too, and the loss against
    one process; no gather over ``model``; one exchange a layer in the
    forward (and its recompute under ``remat``) and one in the backward."""
    cfg = get_config(arch).reduced()
    for out in groups[world]:
        r = out[mesh, arch, "grads"]
        np.testing.assert_allclose(r["loss"], r["loss1"], rtol=1e-6)
        assert max(r["grad_rel"].values()) <= GRAD_REL, r["grad_rel"]
        assert r["grad_rel"]["layers/mamba/in_proj"] <= GRAD_REL
        assert "model" not in {a for axes in r["gathers"] for a in axes}
        calls = r["exchanges"][("model",)][0]
        assert calls == _mixer_exchanges(cfg, "fo", 1)
        assert r["labels"]["mixer_uz"][0] == cfg.n_layers * (1 + cfg.remat)
        assert r["labels"]["mixer_uz_grad"][0] == cfg.n_layers


@pytest.mark.parametrize("kind", ["fo", "zo"])
@pytest.mark.parametrize("arch", H.SSM_ARCHS)
def test_mixer_step_on_model4_matches_reference_and_one_process(
        ssm, groups, one, arch, kind):
    """As ``test_torch_partitioned.py``'s mixer steps, on (data=1, model=4):
    within 2e-5 of the reference's step, the loss and f0, f1 within rtol
    1e-6 of one process's, the parameters within 2% of the update (or one
    float32 ulp) of its FO step or of its ZO step given this run's f0 and
    f1, the same bits on the four ranks, no gather over ``model``, the
    exchanges counted with their bytes (a rank of model=4 receives one or
    two pieces of ``B·S·di/4`` float32 a call, ``uz_plan``)."""
    from repro_torch.models.ssm import uz_plan

    _, _, np_tree = ssm[arch]
    cfg, d = get_config(arch).reduced(), _d(np_tree)
    t = 0 if kind == "fo" else H.ZO_T
    res = [out["1x4", "steps"][f"{arch}-{kind}"] for out in groups[4]]
    recs = [out["1x4", "steps"][f"{arch}-{kind}-records"] for out in groups[4]]
    ref = (_reference_fo if kind == "fo" else _reference_zo)(arch, 2)
    assert _max_diff(res[0]["params"], ref) < 2e-5
    p1, loss1, losses1, bytes1 = _one_process(cfg, np_tree, _batch(512), one,
                                              H.llm_config(d, 2), kind, t)
    if kind == "zo":
        p1 = _one_process_replayed(cfg, np_tree, _batch(512), one, H.llm_config(d, 2), t,
                                   res[0]["losses"])
    assert_update_or_ulp_close(res[0]["params"], p1, _start(np_tree), kind)
    assert res[0]["bytes"] == bytes1
    k = cfg.d_inner // 4
    for rank, (r, rec) in enumerate(zip(res, recs)):
        np.testing.assert_allclose(r["loss"], loss1, rtol=1e-6)
        np.testing.assert_allclose(r["losses"], losses1, rtol=1e-6)
        assert r["losses"] == res[0]["losses"] and rec["sums"] == recs[0]["sums"]
        assert r["gathers"] == {}
        calls, nbytes = r["exchanges"][("model",)]
        assert calls == _mixer_exchanges(cfg, kind, len(r["losses"]))
        pieces = sum(src != rank for src, _, _ in uz_plan(4, k)[rank])
        tokens = r["rows"].size // (2 if kind == "zo" else 1)
        assert nbytes == calls * pieces * tokens * k * 4


def reference_prefill(case, ref):
    """The JAX ``prefill_at`` of ``serve_prompts``: (logits, caches)."""
    toks, last = H.serve_prompts(H.serve_config(case))
    logits, caches = JT.prefill_at(jconfig(case), ref[case][0],
                                   {"tokens": jnp.asarray(toks.numpy())},
                                   jnp.asarray(last.numpy()))
    return np.asarray(logits), caches


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", SERVED)
def test_served_logits_match_reference_and_one_process(ref, groups, served_one, world, case):
    """Prefill logits against the JAX ``prefill_at``; three slot decode steps
    against one process; every rank the same bits."""
    want, _ = reference_prefill(case, ref)
    base, _ = served_one(case)
    atol = _atol(case, base["logits"])
    outs = groups[world]
    for out in outs:
        r = out[f"1x{world}", case]
        np.testing.assert_allclose(r["logits"][0], want, **TOL)
        for step, (got, w) in enumerate(zip(r["logits"], base["logits"])):
            live = [0, 1] if step == 0 else [0, 2]
            np.testing.assert_allclose(got[live], w[live], rtol=RTOL, atol=atol,
                                       err_msg=f"step {step}")
            assert np.array_equal(got, outs[0][f"1x{world}", case]["logits"][step])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", SERVED)
def test_served_collectives_gather_no_weight_and_no_cache(groups, world, case):
    """The prefill's and a decode step's collectives are ``serve_collectives``'
    count and the labelled ones ``serve_collective_bytes``' to the byte; the
    mixer's u and z are exchanged (no ``in_proj`` gather); a decode on an
    ``hd``-cut cache gathers its products, its attention output and the
    logits and nothing else: cache-gather bytes 0."""
    cfg = H.serve_config(case)
    for rank, out in enumerate(groups[world]):
        for kind in ("prefill", "decode"):
            counts = out[f"1x{world}", case][f"{kind}_counts"]
            gathers, exchanges, reduces = H.serve_collectives(cfg, kind, world)
            assert counts["gathers"][("model",)][0] == gathers
            assert counts["exchanges"].get(("model",), [0, 0])[0] == exchanges
            assert counts["reduces"][("model",)][0] == reduces
            rows, seq = (3, H.SERVE_LEN + 8) if kind == "decode" else (2, H.SERVE_LEN)
            named = H.serve_collective_bytes(cfg, kind, world, rank, rows, seq)
            assert counts["labels"] == named, kind
            labelled = sum(named[k][1] for k in ("qkv", "attn_out", "logits") if k in named)
            if kind == "decode":
                assert counts["gathers"][("model",)][1] - labelled == 0    # no cache gathered


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", H.KEPT_HD)
def test_hd_cut_scalar_decode_matches_reference_and_one_process(ref, groups, served_one,
                                                                 world, case):
    """``serve_step`` on the ``hd``-cut cache: one process against the JAX
    ``serve_step`` on the reference's prefill caches (fed the same
    tokens), the ranks against one process, every rank the same bits, and
    the step's gathers its products, attention output and logits alone."""
    _, scalar = served_one(case)
    _, jcaches = reference_prefill(case, ref)
    S = H.SERVE_LEN + 8
    jcaches = {k: jnp.pad(c, [(0, 0), (0, 0), (0, S - c.shape[2])] + [(0, 0)] * (c.ndim - 3))
               if k in ("k", "v") else c for k, c in jcaches.items()}
    for step, tok in enumerate(H.SCALAR_TOKENS):
        want, jcaches = JE.serve_step(jconfig(case), ref[case][0], jnp.asarray(tok, jnp.int32),
                                      jnp.int32(H.SERVE_LEN + step), jcaches)
        np.testing.assert_allclose(scalar["logits"][step], np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
    atol = _atol(case, scalar["logits"])
    cfg = H.serve_config(case)
    outs = groups[world]
    for rank, out in enumerate(outs):
        r = out[f"1x{world}", case, "scalar"]
        for step, (got, w) in enumerate(zip(r["logits"], scalar["logits"])):
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=atol, err_msg=f"step {step}")
            assert np.array_equal(got, outs[0][f"1x{world}", case, "scalar"]["logits"][step])
        named = H.serve_collective_bytes(cfg, "decode", world, rank, 2, S)
        assert r["counts"]["labels"] == named
        assert r["counts"]["gathers"][("model",)][1] == sum(
            named[k][1] for k in ("qkv", "attn_out", "logits"))


# --------------------------------------------------------------------------- #
# controls
# --------------------------------------------------------------------------- #
def test_control_uz_sources_swapped_fails(ref, groups, served_one):
    want, _ = reference_prefill("falcon-mamba", ref)
    base, _ = served_one("falcon-mamba")
    atol = _atol("falcon-mamba", base["logits"])
    for out in groups[2]:
        bad = out["uz-swapped"]
        assert not np.allclose(bad["logits"][0], want, **TOL)
        assert not any(np.allclose(g[[0, 2]], w[[0, 2]], rtol=RTOL, atol=atol)
                       for g, w in zip(bad["logits"][1:], base["logits"][1:]))
        grads = out["uz-swapped-grads"]
        assert abs(grads["loss"] - grads["loss1"]) > 1e-6 * abs(grads["loss1"])
        assert grads["grad_rel"]["layers/mamba/in_proj"] > GRAD_REL


@pytest.mark.parametrize("name,case", [("softcap-before-sum", "hymba-hd-cap"),
                                       ("slice-scaled", "hymba-hd")])
def test_control_logits_scaled_or_capped_off_the_sum_fails(groups, served_one, name, case):
    _, scalar = served_one(case)
    atol = _atol(case, scalar["logits"])
    for out in groups[2]:
        got = out[name]["logits"]
        assert not any(np.allclose(g, w, rtol=RTOL, atol=atol)
                       for g, w in zip(got, scalar["logits"]))


# --------------------------------------------------------------------------- #
# attention cut inside a head: the products gathered, not wq/wk/wv
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference_lowering():
    """program -> the reference's collectives on a (data=1, model=2) CPU
    mesh, ``(kind, shapes)`` in program order (one shape, or a tuple's),
    as ``tests/helpers/reference_collectives.py attention`` prints them."""
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "JAX_PLATFORMS": "cpu"}
    text = subprocess.run([sys.executable, str(root / "tests/helpers/reference_collectives.py"),
                           "attention"], env=env, capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        if line.startswith("  ") and name:
            kind, shape = line.split(None, 1)
            out[name].append((kind, tuple(tuple(int(n) for n in dims.split(",")) for dims
                                          in re.findall(r"\[([\d,]*)\]", shape))))
        elif line.endswith(" collectives"):
            name = line.split(":")[0]
            out[name] = []
    return out


@pytest.fixture(scope="module")
def attention_one(attn):
    """The port's one-process ``attention_run`` on ``attn``."""
    return H.attention_run(get_config("hymba-1.5b"), *attn)


def _rank_slice(name, g_whole, g_rank, rank):
    """Of a whole gradient, the slice this rank's shard holds (wq/wk/wv its
    columns, wo its rows, x whole)."""
    if name in ("wq", "wk", "wv"):
        n = g_rank.shape[1]
        return g_whole[:, rank * n:(rank + 1) * n]
    if name == "wo":
        n = g_rank.shape[0]
        return g_whole[rank * n:(rank + 1) * n]
    return g_whole


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_head_cut_attention_matches_reference_and_one_process(attn, groups, attention_one):
    """hymba-1.5b's attention at full width on model=2: the forward, prefill
    and the gradient w.r.t. the parameters and x against the JAX package and
    one process; each rank's k/v cache its slice of ``hd``.  A gradient's
    atol is 1e-5 of its leaf's largest |g| (entries reach ~10: each sums
    B·S = 128 tokens' float32 products, in another order in each
    framework)."""
    p_np, x_np = attn
    cfg = jget_config("hymba-1.5b")
    p, x = jax.tree.map(jnp.asarray, p_np), jnp.asarray(x_np)
    want = np.asarray(JA.attention_forward(cfg, p, x))
    want_pre, (jk, jv) = JA.attention_prefill(cfg, p, x)
    jg = jax.grad(lambda p, x: JA.attention_forward(cfg, p, x).sum(), argnums=(0, 1))(p, x)
    jgrads = {**jax.tree.map(np.asarray, jg[0]), "x": np.asarray(jg[1])}
    hd = cfg.head_dim // 2
    for rank, out in enumerate(groups[2]):
        r = out["attention"]
        np.testing.assert_allclose(r["forward"], want, **TOL)
        np.testing.assert_allclose(r["prefill"], np.asarray(want_pre), **TOL)
        np.testing.assert_allclose(r["forward"], attention_one["forward"], rtol=RTOL, atol=1e-5)
        for got, whole in ((r["k"], jk), (r["v"], jv)):
            np.testing.assert_allclose(got, np.asarray(whole)[..., rank * hd:(rank + 1) * hd],
                                       **TOL)
        assert set(r["grads"]) == set(jgrads)
        for name, g in r["grads"].items():
            want_g = _rank_slice(name, jgrads[name], g, rank)
            np.testing.assert_allclose(g, want_g, rtol=TOL["rtol"],
                                       atol=TOL["atol"] * float(np.abs(want_g).max()),
                                       err_msg=name)
            one = _rank_slice(name, attention_one["grads"][name], g, rank)
            assert _rel(g, one) <= GRAD_REL, name


def _multiset(found):
    return sorted((kind, shapes if isinstance(shapes[0], tuple) else (shapes,))
                  for kind, shapes in found)


def test_head_cut_attention_collectives_are_the_references(groups, reference_lowering):
    """By kind and shape: the forward's and the prefill's collectives are the
    reference's (the q, k and v products gathered, the ``wo`` all-reduce);
    the gradient's are the reference's gradient program's, where two
    differences are by design: the port's eager forward keeps its ``wo``
    all-reduce (the reference's compiler drops it, since the gradient does
    not read the output), and x's gradient is one all-reduce of the sum of
    the three products' transposes where the reference all-reduces the three
    as one tuple."""
    ref = reference_lowering
    x_shape = (2, 64, 1600)
    grad_ref = [c for c in ref["grad of attention_forward"] if c[0] != "all-reduce"]
    tuple_reduce = [c for c in ref["grad of attention_forward"] if c[0] == "all-reduce"]
    assert tuple_reduce == [("all-reduce", (x_shape,) * 3)]
    for out in groups[2]:
        r = out["attention"]
        assert _multiset(r["forward_collectives"]) == _multiset(ref["attention_forward"])
        assert _multiset(r["prefill_collectives"]) == _multiset(ref["attention_prefill"])
        fwd = r["grad_forward_collectives"]
        assert _multiset(fwd) == _multiset(ref["attention_forward"])
        gathers = [c for c in fwd + r["backward_collectives"] if c[0] == "all-gather"]
        assert _multiset(gathers) == _multiset(grad_ref)
        assert [c for c in r["backward_collectives"] if c[0] == "all-reduce"] == [
            ("all-reduce", x_shape)]


def test_head_cut_attention_gathers_and_all_reduces_no_weight(attn, groups):
    """Every byte gathered over ``model`` is the products' (``qkv``) or the
    output gradient's (``attn_out_grad``), and every byte all-reduced is
    the ``wo`` partials' or x's gradient's: no weight and no weight
    gradient crosses ranks."""
    cfg = get_config("hymba-1.5b")
    B, S, D = attn[1].shape
    for out in groups[2]:
        r = out["attention"]
        fwd, bwd = r["grad_forward_counts"], r["backward_counts"]
        assert fwd["labels"] == H.head_cut_gathers(cfg, B, S, layers=1)
        assert bwd["labels"] == {"attn_out_grad": [1, B * S * cfg.n_heads * cfg.head_dim * 4]}
        for counts in (fwd, bwd):
            assert counts["gathers"] == {("model",): [sum(c for c, _ in counts["labels"].values()),
                                                      sum(b for _, b in counts["labels"].values())]}
            assert counts["reduces"] == {("model",): [1, B * S * D * 4]}
            assert counts["exchanges"] == {}
        # activations (B, S, ...) all: a weight is (D, ...) or (..., D)
        assert all(s[:2] == (B, S) for _, s in r["forward_collectives"] + r["prefill_collectives"]
                   + r["grad_forward_collectives"] + r["backward_collectives"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(H.HEAD_CUT))
def test_head_cut_training_matches_one_process_gathering_products(groups, case, world):
    """The ``HEAD_CUT`` configs' loss and every gradient against one process
    on model=``world``; the gathers over ``model`` are the products' in the
    forward and its recompute under ``remat`` and the output gradient's in
    the backward, to the byte, and nothing else."""
    cfg = H.head_cut_config(case)
    want = H.head_cut_gathers(cfg, 4, 16, forwards=1 + cfg.remat, backwards=1)
    for out in groups[world]:
        r = out[f"1x{world}", case, "grads"]
        np.testing.assert_allclose(r["loss"], r["loss1"], rtol=1e-6)
        assert max(r["grad_rel"].values()) <= GRAD_REL, r["grad_rel"]
        assert {k: v for k, v in r["labels"].items() if k in ("qkv", "attn_out_grad")} == want
        assert r["gathers"] == {("model",): [sum(c for c, _ in want.values()),
                                             sum(b for _, b in want.values())]}


def test_control_split_backward_only_slicing_fails(groups, attention_one):
    """``ModelAxis.split`` whose backward only slices: each rank's attention
    backward sees its columns of the output gradient alone, and the
    gradients of wq, wk, wv and x leave one process's."""
    for rank, out in enumerate(groups[2]):
        good, bad = out["attention"], out["split-only-slices"]
        np.testing.assert_array_equal(bad["forward"], good["forward"])
        for name in ("wq", "wk", "wv", "x"):
            one = _rank_slice(name, attention_one["grads"][name], bad["grads"][name], rank)
            assert _rel(bad["grads"][name], one) > GRAD_REL, name
