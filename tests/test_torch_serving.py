"""The port's serving path (``repro_torch.serving``) on the CPU.

Token identity at temperature 0 with the JAX package's ``Engine.generate``
on ``qwen3-14b.reduced()`` and ``gemma2-2b.reduced()``, from the same
parameters (JAX's, carried across with ``repro_torch.convert``), with
``use_pallas`` on: prompt lengths cross the 64-token line, so the 64- and
128-token buckets take the flash path (the reference's Pallas kernel in
interpret mode, the port's plain version of its CUDA kernel) and the others
the plain path.  Then the non-traffic cases of ``tests/test_serving.py``,
within the port: batched and deterministic generation, prefill buckets,
prefill + decode against teacher forcing, randomized slot invariants, EOS
freeing its slot, the early-exit step count, and sampling that does not
depend on the slot count.  Logit comparisons use atol 1e-4, as the
reference's own test does.  ``falcon-mamba-7b.reduced()`` (SSM) prefills at
exact length: token identity with the reference on the plain path and
through the selective-scan kernel path (64-aligned prompts), the slot
writes of its conv and ssm states, and the reference's decode after a
prompt shorter than the conv window, which the port mirrors.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as J
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving import SlotKVCache as JSlotKVCache
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, ServeConfig, SlotKVCache, sample_key

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

MAX_SEQ = 48
ROOT = Path(__file__).resolve().parents[1]


def setup(arch, seed, **kw):
    jcfg = jget_config(arch).reduced().with_(remat=False, **kw)
    cfg = get_config(arch).reduced().with_(remat=False, **kw)
    jp = J.init_model(jax.random.key(seed), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jp, device="cpu")


@pytest.fixture(scope="module")
def qwen():
    _, _, cfg, params = setup("qwen3-14b", 0)
    return cfg, params


def mixed_prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in lens]


# --------------------------------------------------------------------------- #
# token identity with the reference engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,seed", [("qwen3-14b", 0), ("gemma2-2b", 1)])
def test_token_identity_vs_reference_engine(arch, seed):
    jcfg, jp, cfg, tp = setup(arch, seed, use_pallas=True)
    prompts = mixed_prompts(cfg, (5, 40, 65, 70, 100, 9, 130), seed=2)
    sc = dict(max_seq=150, slots=3)
    want = JEngine(jcfg, jp, JServeConfig(**sc)).generate(prompts, max_new=8)
    eng = Engine(cfg, tp, ServeConfig(**sc))
    assert eng.generate(prompts, max_new=8) == want
    # buckets 64 and 128 are multiples of 64: the flash path (for qwen3; gemma2's
    # mixed windows keep even those on the plain path, as in the reference)
    assert eng.scheduler.prefill_buckets() == (8, 16, 64, 128, 150)


@pytest.fixture(scope="module")
def mamba():
    return setup("falcon-mamba-7b", 2)


def test_token_identity_ssm_exact_length_prefill(mamba):
    """SSM configs prefill at exact length (pad tokens would corrupt the
    post-prompt state); the slot-pool decode gives the reference engine's
    tokens (``tests/test_serving.py``'s case, against the JAX engine)."""
    jcfg, jp, cfg, tp = mamba
    prompts = mixed_prompts(cfg, (5, 9, 3), seed=4)
    want = JEngine(jcfg, jp, JServeConfig(max_seq=32, slots=2)).generate(prompts, max_new=6)
    eng = Engine(cfg, tp, ServeConfig(max_seq=32, slots=2))
    assert eng.generate(prompts, max_new=6) == want
    assert eng.scheduler.prefill_buckets() == (3, 5, 9)  # exact, not bucketed


def test_token_identity_ssm_kernel_path():
    """With ``use_pallas``, the 64- and 128-token prompts' prefills run the
    selective-scan path (the reference's Pallas kernel in interpret mode,
    the port's plain version), the 5-token one the plain scan."""
    jcfg, jp, cfg, tp = setup("falcon-mamba-7b", 3, use_pallas=True)
    prompts = mixed_prompts(cfg, (64, 5, 128), seed=9)
    want = JEngine(jcfg, jp, JServeConfig(max_seq=140, slots=2)).generate(prompts, max_new=6)
    eng = Engine(cfg, tp, ServeConfig(max_seq=140, slots=2))
    assert eng.generate(prompts, max_new=6) == want
    assert eng.scheduler.prefill_buckets() == (5, 64, 128)


@pytest.mark.parametrize("L", [1, 2, 3, 5])
def test_ssm_short_prompt_decode_mirrors_reference(L, mamba):
    """A reference behaviour the port keeps: after a prefill of fewer than
    ``ssm_conv - 1 = 3`` tokens, the prompt's rows fill the TOP of the
    slot's conv state (not ``[0, u0, u1]``), so the first decode step
    departs from the teacher-forced forward pass.  The port equals the
    reference either way; from 3 tokens on both equal teacher forcing."""
    jcfg, jp, cfg, tp = mamba
    prompt = mixed_prompts(cfg, (L + 1,), seed=10)[0]
    tf, _ = T.forward_logits(cfg, tp, {"tokens": torch.tensor([prompt])})
    jpool = JSlotKVCache(jcfg, slots=2, max_seq=16)
    tpool = SlotKVCache(cfg, slots=2, max_seq=16, device="cpu")
    _, jc = J.prefill(jcfg, jp, {"tokens": np.asarray([prompt[:L]], np.int32)})
    _, tc = T.prefill(cfg, tp, {"tokens": torch.tensor([prompt[:L]])})
    for pool, c in ((jpool, jc), (tpool, tc)):
        pool.alloc(0)
        pool.assign(0, c, L)
    tok, pos = np.array([prompt[L], 0], np.int32), np.array([L, -1], np.int32)
    want, _ = J.decode_step_slots(jcfg, jp, tok, pos, jpool.caches)
    got, _ = T.decode_step_slots(cfg, tp, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos), tpool.caches)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], atol=1e-4)
    gap = float((got[0] - tf[0, L]).abs().max())
    if L < cfg.ssm_conv - 1:
        assert gap > 0.05, gap       # the misaligned conv window shows
    else:
        assert gap < 1e-4, gap


@pytest.mark.parametrize("L", [2, 5])
def test_slot_assign_writes_ssm_states(L, mamba):
    """``assign`` writes a prefill's ssm state whole and its conv state into
    the leading ``min(L, K - 1)`` rows of the slot, and nothing else."""
    _, _, cfg, tp = mamba
    pool = SlotKVCache(cfg, slots=3, max_seq=16, device="cpu")
    for c in pool.caches.values():
        c.fill_(7.0)
    _, tc = T.prefill(cfg, tp, {"tokens": torch.arange(1, L + 1)[None]})
    slot = pool.alloc(0)
    slot = pool.alloc(1)
    pool.assign(slot, tc, L)
    assert slot == 1 and sorted(pool.caches) == ["conv", "ssm"]
    rows = min(L, cfg.ssm_conv - 1)
    assert torch.equal(pool.caches["ssm"][:, 1], tc["ssm"][:, 0])
    assert torch.equal(pool.caches["conv"][:, 1, :rows], tc["conv"][:, 0])
    assert bool((pool.caches["conv"][:, 1, rows:] == 7.0).all())
    for k in ("conv", "ssm"):
        assert bool((pool.caches[k][:, [0, 2]] == 7.0).all())


def test_slot_cache_defaults_to_the_card(qwen):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        SlotKVCache(qwen[0], slots=2, max_seq=8)


# --------------------------------------------------------------------------- #
# the reference's serving cases, within the port
# --------------------------------------------------------------------------- #
def test_generate_batched(qwen):
    cfg, params = qwen
    eng = Engine(cfg, params, ServeConfig(max_seq=MAX_SEQ, slots=3))
    prompts = mixed_prompts(cfg, (5, 9, 3, 7))
    outs = eng.generate(prompts, max_new=6)
    assert len(outs) == 4
    for p, o in zip(prompts, outs):
        assert o[: len(p)] == p
        assert len(o) == len(p) + 6
        assert all(0 <= t < cfg.vocab_size for t in o)


def test_generate_greedy_deterministic(qwen):
    cfg, params = qwen
    eng = Engine(cfg, params, ServeConfig(max_seq=MAX_SEQ, slots=2))
    prompts = [[1, 2, 3, 4], [5, 6, 7]]
    assert eng.generate(prompts, max_new=5) == eng.generate(prompts, max_new=5)


def test_generate_temperature_uses_key(qwen):
    cfg, params = qwen
    eng = Engine(cfg, params, ServeConfig(max_seq=MAX_SEQ, temperature=1.0))
    prompts = [[1, 2, 3]]
    a = eng.generate(prompts, max_new=8, key=0)
    b = eng.generate(prompts, max_new=8, key=1)
    assert a != b  # overwhelmingly likely with a random model
    assert a == eng.generate(prompts, max_new=8, key=0)


def test_prefill_buckets_cached(qwen):
    cfg, params = qwen
    eng = Engine(cfg, params, ServeConfig(max_seq=MAX_SEQ, slots=4))
    eng.generate(mixed_prompts(cfg, (5, 9, 7)), max_new=2)
    assert eng.scheduler.prefill_buckets() == (8, 16)


def test_prefill_decode_matches_teacher_forced(qwen):
    cfg, params = qwen
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    ref_logits, _ = T.forward_logits(cfg, params, {"tokens": torch.tensor([prompt])})
    # bucketed prefill of the first 4 tokens (padded to 8), logits at pos 3
    L0, bucket, S = 4, 8, 24
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :L0] = torch.tensor(prompt[:L0])
    lg, caches = T.prefill_at(cfg, params, {"tokens": toks}, torch.tensor([L0 - 1]))
    assert int(lg[0].argmax()) == int(ref_logits[0, L0 - 1].argmax())
    np.testing.assert_allclose(lg[0].numpy(), ref_logits[0, L0 - 1].numpy(), atol=1e-4)
    # teacher-force the rest through the slot pool (slot 1 of 3, others idle)
    pool = T.init_caches(cfg, 3, S, torch.float32, device="cpu")
    for k in pool:
        pool[k][:, 1, :bucket] = caches[k][:, 0]
    for step in range(L0, len(prompt)):
        tok = torch.tensor([0, prompt[step], 0])
        pos = torch.tensor([-1, step, -1], dtype=torch.int32)
        lg, pool = T.decode_step_slots(cfg, params, tok, pos, pool)
        assert int(lg[1].argmax()) == int(ref_logits[0, step].argmax())
        np.testing.assert_allclose(lg[1].numpy(), ref_logits[0, step].numpy(), atol=1e-4)


def test_slot_invariants_randomized(qwen):
    cfg, params = qwen
    pool = SlotKVCache(cfg, slots=4, max_seq=16, device="cpu")
    rng = np.random.default_rng(0)
    live = {}
    next_rid = 0
    caches = None
    for _ in range(60):
        if live and (len(live) == pool.slots or rng.random() < 0.4):
            slot = rng.choice(sorted(live))
            del live[slot]
            pool.evict(int(slot))
        else:
            rid = next_rid
            next_rid += 1
            slot = pool.alloc(rid)
            assert slot is not None and slot not in live
            L = int(rng.integers(2, 8))
            _, caches = T.prefill(cfg, params,
                                  {"tokens": torch.full((1, L), rid % cfg.vocab_size)})
            pool.assign(slot, caches, L)
            live[slot] = (rid, L, caches)
        pool.check_invariants()
        assert pool.free_slots == pool.slots - len(live)
    # gather returns exactly what was assigned to each live slot
    for slot, (rid, L, c) in live.items():
        got = pool.gather([slot])
        assert torch.equal(got["k"][:, 0, :L], c["k"][:, 0])
    # exhaustion: filling the pool makes alloc return None
    while pool.free_slots:
        s = pool.alloc(10_000 + pool.free_slots)
        pool.assign(s, live[max(live)][2] if live else caches, 2)
    assert pool.alloc(99999) is None
    pool.evict(0)
    with pytest.raises(AssertionError):
        pool.evict(0)  # double-evict of an already-free slot


def test_eos_honored_and_slot_freed(qwen):
    cfg, params = qwen
    prompts = mixed_prompts(cfg, (5, 7, 4), seed=5)
    ref = Engine(cfg, params, ServeConfig(max_seq=MAX_SEQ, slots=3)).generate(prompts, max_new=8)
    eos = ref[0][len(prompts[0]) + 3]
    eng = Engine(cfg, params, ServeConfig(max_seq=MAX_SEQ, slots=3, eos_id=eos))
    outs = eng.generate(prompts, max_new=8)
    truncated = 0
    for i in range(3):
        gen = outs[i][len(prompts[i]):]
        ref_gen = ref[i][len(prompts[i]):]
        if eos in ref_gen:
            assert gen == ref_gen[: ref_gen.index(eos) + 1]
            assert gen[-1] == eos
            truncated += 1
        else:
            assert gen == ref_gen
    assert truncated >= 1
    assert eng.scheduler.pool.live_slots() == []  # every slot returned


def test_offline_early_exit_step_count(qwen):
    cfg, params = qwen
    prompts = mixed_prompts(cfg, (5, 7), seed=6)
    ref = Engine(cfg, params, ServeConfig(max_seq=MAX_SEQ, slots=2)).generate(prompts, max_new=10)
    eos = ref[0][len(prompts[0]) + 1]   # request 0's 2nd generated token

    def drain_steps(sc, reqs):
        eng = Engine(cfg, params, sc)
        for i, p in enumerate(reqs):
            eng.submit(p, 10, key_id=i)
        n = 0
        while eng.has_work:
            eng.step()
            n += 1
        return n

    # the admission step emits two tokens (prefill + same-step decode), then
    # max_new - 2 pure decode steps
    assert drain_steps(ServeConfig(max_seq=MAX_SEQ, slots=2), prompts) == 9
    assert drain_steps(ServeConfig(max_seq=MAX_SEQ, slots=2, eos_id=eos), prompts[:1]) == 1


def test_sampling_invariant_to_slot_count(qwen):
    """temperature > 0 outputs depend only on (seed, request index, step):
    the same workload through 1 slot and 4 slots samples the same tokens."""
    cfg, params = qwen
    prompts = mixed_prompts(cfg, (5, 9, 3, 7), seed=7)
    outs = [Engine(cfg, params, ServeConfig(max_seq=MAX_SEQ, slots=slots, temperature=1.0))
            .generate(prompts, max_new=6, key=42) for slots in (1, 4)]
    assert outs[0] == outs[1]


def test_sample_key_one_fold_per_component():
    draw = lambda *a: torch.rand(4, generator=sample_key(*a))  # noqa: E731
    assert torch.equal(draw(0, 3, 5), draw(0, 3, 5))
    assert not torch.equal(draw(0, 3, 6), draw(0, 3, 5))
    assert not torch.equal(draw(0, 4, 5), draw(0, 3, 5))
    assert not torch.equal(draw(1, 3, 5), draw(0, 3, 5))


def test_serve_cli_offline_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", "qwen3-14b", "--reduce", "smoke",
                    "--batch", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.count("req") == 3 and "decoded 12 tokens" in out
    with pytest.raises(SystemExit, match="ROADMAP Queue 1 item 13"):
        serve_cli.main(["--device", "cpu", "--traffic", "poisson:10"])


def test_serve_cli_ssm_offline_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", "falcon-mamba-7b", "--reduce", "smoke",
                    "--batch", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.count("req") == 3 and "decoded 12 tokens" in out and "tok/s" in out


def test_serving_imports_no_jax():
    code = ("import sys; import repro_torch.serving, repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
