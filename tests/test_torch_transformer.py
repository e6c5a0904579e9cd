"""The port's dense decoder against the JAX package, on the CPU.

The same parameters (JAX's ``init_model``, carried across with
``repro_torch.convert``) and the same numpy tokens go through both
packages' ``forward_logits``, ``prefill_at`` and ``decode_step_slots``, with
``use_pallas`` off (the plain q-chunked path) and on (the flash path: the
reference runs its Pallas kernel in interpret mode, the port the kernel's
plain version, as on any CPU tensor).  Configs: ``qwen3-14b.reduced()``
(qk-norm, swiglu) and a GQA variant with 2 KV heads (``reduced()`` alone
gives 4/4), ``gemma2-2b.reduced()`` with ``long_context`` (one window over
every layer: the kernel path with window and softcap) and without (mixed
windows: the plain path even with ``use_pallas``), ``starcoder2-3b.reduced()``
(layernorm, gelu, GQA 4/2), ``phi3-mini-3.8b.reduced()`` and
``falcon-mamba-7b.reduced()`` (mamba layers: with ``use_pallas`` an aligned
length takes the selective-scan path, the reference's Pallas kernel in
interpret mode and the port's plain version of its CUDA kernel; SSM prefills
run at exact length and carry conv and ssm states).  All float32.

Tolerance: logits and caches within rtol 1e-5 / atol 1e-5 of the
reference's (logits reach 1.5 here).  The two frameworks sum the matrix
products and the softmax in other orders, which moves float32 results by
~1e-7 relative per operation; two layers of that left at most 1.9e-6 on the
logits when measured, so the tolerance has a 5x margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import transformer as J
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    "qwen3": ("qwen3-14b", {}),
    "qwen3-gqa": ("qwen3-14b", {"n_kv_heads": 2}),
    "gemma2-long": ("gemma2-2b", {"long_context": True}),
    "gemma2": ("gemma2-2b", {}),
    "starcoder2": ("starcoder2-3b", {}),
    "phi3": ("phi3-mini-3.8b", {}),
    "falcon-mamba": ("falcon-mamba-7b", {}),
}


def configs(case, use_pallas):
    arch, kw = CASES[case]
    kw = dict(kw, remat=False, use_pallas=use_pallas)
    return jget_config(arch).reduced().with_(**kw), get_config(arch).reduced().with_(**kw)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.fixture(scope="module")
def jparams():
    cache = {}

    def get(case):
        if case not in cache:
            jcfg, _ = configs(case, False)
            p = J.init_model(jax.random.key(0), jcfg)
            cache[case] = (p, params_from_numpy(p, device="cpu"))
        return cache[case]
    return get


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_matches_jax(case, use_pallas, jparams):
    jcfg, cfg = configs(case, use_pallas)
    jp, tp = jparams(case)
    S = 128 if case in ("qwen3", "gemma2-long", "phi3") else 64
    toks = tokens(cfg, 2, S)
    want, _ = J.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, aux = T.forward_logits(cfg, tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, S, cfg.vocab_size) and float(aux) == 0.0
    close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["qwen3-gqa", "gemma2-long", "gemma2", "starcoder2"])
def test_prefill_then_slot_decode_matches_jax(case, use_pallas, jparams):
    """A right-padded 64-token prefill of two prompts (logits at their last
    real tokens, caches), its caches placed in slots 0 and 2 of a 3-slot
    pool (slot 1 inactive), then three decode steps at per-slot positions."""
    jcfg, cfg = configs(case, use_pallas)
    jp, tp = jparams(case)
    S, max_seq = 64, 72
    toks = tokens(cfg, 2, S, seed=1)
    last = np.array([40, 63], np.int32)
    want, jc = J.prefill_at(jcfg, jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(last))
    got, tc = T.prefill_at(cfg, tp, {"tokens": torch.from_numpy(toks).long()},
                           torch.from_numpy(last))
    close(got, want)
    for k in ("k", "v"):
        close(tc[k], jc[k])

    jpool = J.init_caches(jcfg, 3, max_seq, jnp.float32)
    tpool = T.init_caches(cfg, 3, max_seq, torch.float32, device="cpu")
    for row, slot in ((0, 0), (1, 2)):
        jpool = jax.tree.map(
            lambda p, c: p.at[:, slot, :S].set(c[:, row]), jpool, jc)
        for k in ("k", "v"):
            tpool[k][:, slot, :S] = tc[k][:, row]
    pos = np.array([last[0] + 1, -1, last[1] + 1], np.int32)
    cur = np.array([5, 0, 7], np.int32)
    for _ in range(3):
        want, jpool = J.decode_step_slots(jcfg, jp, jnp.asarray(cur), jnp.asarray(pos), jpool)
        got, tpool = T.decode_step_slots(cfg, tp, torch.from_numpy(cur).long(),
                                         torch.from_numpy(pos), tpool)
        live = pos >= 0
        close(got[live], np.asarray(want)[live])
        cur = np.where(live, np.asarray(want).argmax(-1), 0).astype(np.int32)
        pos = np.where(live, pos + 1, -1).astype(np.int32)
    for k in ("k", "v"):
        close(tpool[k], jpool[k])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("S", [64, 5])
def test_ssm_prefill_then_slot_decode_matches_jax(S, use_pallas, jparams):
    """falcon-mamba: an exact-length prefill of two prompts (logits at the
    last token, conv and ssm states), its states placed in slots 0 and 2 of
    a 3-slot pool (slot 1 inactive: its state is updated all the same, as in
    the reference), then three decode steps.  S=64 with ``use_pallas`` runs
    the scan through the kernel path."""
    jcfg, cfg = configs("falcon-mamba", use_pallas)
    jp, tp = jparams("falcon-mamba")
    toks = tokens(cfg, 2, S, seed=8)
    last = np.array([S - 1, S - 1], np.int32)
    want, jc = J.prefill_at(jcfg, jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(last))
    got, tc = T.prefill_at(cfg, tp, {"tokens": torch.from_numpy(toks).long()},
                           torch.from_numpy(last))
    close(got, want)
    assert sorted(tc) == sorted(jc) == ["conv", "ssm"]
    assert tc["ssm"].dtype == torch.float32
    assert tuple(tc["conv"].shape) == (cfg.n_layers, 2, cfg.ssm_conv - 1, cfg.d_inner)
    for k in jc:
        close(tc[k], jc[k])
    jpool = J.init_caches(jcfg, 3, 80, jnp.float32)
    tpool = T.init_caches(cfg, 3, 80, torch.float32, device="cpu")
    for row, slot in ((0, 0), (1, 2)):
        jpool = jax.tree.map(lambda p, c: p.at[:, slot].set(c[:, row]), jpool, jc)
        for k in jc:
            tpool[k][:, slot] = tc[k][:, row]
    pos = np.array([S, -1, S], np.int32)
    cur = np.array([5, 0, 7], np.int32)
    for _ in range(3):
        want, jpool = J.decode_step_slots(jcfg, jp, jnp.asarray(cur), jnp.asarray(pos), jpool)
        got, tpool = T.decode_step_slots(cfg, tp, torch.from_numpy(cur).long(),
                                         torch.from_numpy(pos), tpool)
        close(got, want)
        cur = np.asarray(want).argmax(-1).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, -1).astype(np.int32)
    for k in jc:
        close(tpool[k], jpool[k])


@pytest.mark.parametrize("case", ["gemma2-long", "qwen3-gqa", "falcon-mamba"])
def test_scalar_position_decode_matches_jax(case, jparams):
    """``decode_step`` (one position for the whole batch): with a uniform
    static window, which reads only the last W cache rows, and without; and
    the SSM's recurrence from the zero state."""
    jcfg, cfg = configs(case, False)
    jp, tp = jparams(case)
    B, S = 2, 16
    jcache = J.init_caches(jcfg, B, S, jnp.float32)
    tcache = T.init_caches(cfg, B, S, torch.float32, device="cpu")
    toks = tokens(cfg, B, 12, seed=2)
    for t in range(12):
        want, jcache = J.decode_step(jcfg, jp, jnp.asarray(toks[:, t]), jnp.int32(t), jcache)
        got, tcache = T.decode_step(cfg, tp, torch.from_numpy(toks[:, t]).long(), t, tcache)
        close(got, want)


def test_layers_match_jax():
    """Norms (fp32 inside, back to the input dtype, (1 + scale)), the three
    MLP activations, rope and softcap, on bf16 and fp32 inputs."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    bias = rng.standard_normal(32).astype(np.float32) * 0.1
    pos = np.arange(5, dtype=np.int32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, dict(rtol=1e-5, atol=1e-6)),
                         (torch.bfloat16, jnp.bfloat16, dict(rtol=1e-2, atol=1e-2))):
        jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(dt)
        pairs = [
            (L.rmsnorm(tx, torch.from_numpy(scale)), JL.rmsnorm(jx, jnp.asarray(scale))),
            (L.layernorm(tx, torch.from_numpy(scale), torch.from_numpy(bias)),
             JL.layernorm(jx, jnp.asarray(scale), jnp.asarray(bias))),
            (L.apply_rope(tx, torch.from_numpy(pos), 1e6), JL.apply_rope(jx, jnp.asarray(pos), 1e6)),
            (L.softcap(tx * 40, 30.0), JL.softcap(jx * 40, 30.0)),
        ]
        for got, want in pairs:
            assert got.dtype == dt
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    for act in ("swiglu", "geglu", "gelu"):
        jcfg = jget_config("qwen3-14b").reduced().with_(activation=act)
        cfg = get_config("qwen3-14b").reduced().with_(activation=act)
        jp = JL.init_mlp(jax.random.key(1), jcfg, 64, jnp.float32)
        h = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        got = L.apply_mlp(cfg, params_from_numpy(jp, device="cpu"), torch.from_numpy(h))
        close(got, JL.apply_mlp(jcfg, jp, jnp.asarray(h)), rtol=1e-5, atol=1e-5)


def test_bf16_tree_carries_bit_for_bit():
    """A full-dtype (bf16) JAX init tree becomes the port's tree leaf for leaf,
    bit for bit, with the layers stacked on axis 0 and norms in float32."""
    jcfg = jget_config("qwen3-14b").reduced().with_(dtype="bfloat16")
    jp = J.init_model(jax.random.key(4), jcfg)
    tp = params_from_numpy(jp, device="cpu")
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).endswith(str(a.dtype))
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    assert tp["layers"]["attn"]["wq"].shape[0] == jcfg.n_layers
    assert tp["layers"]["attn"]["q_norm"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen3-14b", "falcon-mamba-7b"])
def test_port_init_shapes_dtypes_and_count(arch):
    """The port's own init gives the reference's tree structure, shapes and
    dtypes, and ``param_count()`` counts its parameters."""
    cfg = get_config(arch).reduced().with_(dtype="bfloat16")
    jcfg = jget_config(arch).reduced().with_(dtype="bfloat16")
    tp = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    jshapes = jax.eval_shape(lambda k: J.init_model(k, jcfg), jax.random.key(0))
    assert jax.tree.structure(jshapes) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for a, b in zip(jax.tree.leaves(jshapes), tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape) and str(b.dtype).endswith(str(a.dtype))
    assert sum(t.numel() for t in tree_leaves(tp)) == cfg.param_count()
    # a seed gives the same parameters every time
    again = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(again)))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "hymba-1.5b", "pixtral-12b",
                                  "hubert-xlarge"])
def test_unported_architectures_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        T.init_model(0, cfg)


@pytest.mark.parametrize("arch", ["qwen3-14b", "falcon-mamba-7b"])
def test_entry_points_default_to_the_card(arch):
    """Without a device argument the model stack asks for the card, and
    raises where there is none rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = get_config(arch).reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_model(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_caches(cfg, 2, 16, torch.float32)
