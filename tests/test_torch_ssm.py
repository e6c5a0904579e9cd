"""The port's mamba block (``repro_torch.models.ssm``) against the JAX package.

The same parameters (``repro.models.ssm.init_mamba``, carried across with
``repro_torch.convert``) and the same numpy inputs go through both
packages' ``mamba_forward`` on each of its paths: the plain associative
scan (a 64-aligned length and an odd one), the ``ssm_chunk`` scan over
sequence chunks, and the kernel path (``use_pallas`` at d_model=128, S=128:
the reference's Pallas kernel in interpret mode, the port's plain version
of its CUDA kernel); then ``mamba_decode`` step by step.  Tolerance rtol =
atol = 2e-4 (outputs reach ~1.2; the two frameworks round the matrix
products in other orders, ~1e-7 relative when measured).  The associative
scan itself keeps the reference's combination order, so it is held bitwise.

The prefill's decode state (``falcon-mamba-7b.reduced()``, the whole model):
on the kernel path the ssm state is the scan kernel's final state (here its
plain version, the sequential recurrence) and the plain tail-state scan is
not run; the caches are held against the reference's ``prefill``, which
takes the state from its associative scan, within 1e-5 of max|h| (the two
orders round differently, by a few float32 ulp; the matrix products add
~1e-7 relative).  Off the kernel path (``use_pallas`` off, or a length that
is not a multiple of 64) the tail-state scan runs once per layer, as in the
reference.  ``kernel_path`` keeps the reference's gate on the CPU and where
no device is given; off the CPU (the card, the dry run's ``meta``) every
length takes the kernel, which has no backward: a gradient through it
raises there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
D_MODEL = 128


def configs(**kw):
    kw = dict(kw, d_model=D_MODEL)
    return (jget_config("falcon-mamba-7b").reduced().with_(**kw),
            get_config("falcon-mamba-7b").reduced().with_(**kw))


@pytest.fixture(scope="module")
def params():
    jcfg, _ = configs()
    jp = JS.init_mamba(jax.random.key(0), jcfg, jnp.float32)
    return jp, params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("path,seq,kw", [
    ("plain", 128, {}),
    ("plain-odd-length", 37, {}),
    ("ssm_chunk", 128, {"ssm_chunk": 32}),
    ("kernel", 128, {"use_pallas": True}),
])
def test_mamba_forward_matches_jax(path, seq, kw, params):
    jcfg, cfg = configs(**kw)
    jp, tp = params
    x = np.random.default_rng(seq).standard_normal((2, seq, D_MODEL)).astype(np.float32)
    want = JS.mamba_forward(jcfg, jp, jnp.asarray(x))
    got = S.mamba_forward(cfg, tp, torch.from_numpy(x))
    assert got.shape == (2, seq, D_MODEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssm_chunk_requires_whole_chunks(params):
    _, cfg = configs(ssm_chunk=32)
    with pytest.raises(ValueError, match="ssm_chunk"):
        S.mamba_forward(cfg, params[1], torch.zeros(1, 48, D_MODEL))


def test_mamba_decode_step_by_step_matches_jax(params):
    """Eight single-token steps from the zero state, then the states."""
    jcfg, cfg = configs()
    jp, tp = params
    jstate = JS.init_mamba_state(jcfg, 3, jnp.float32)
    tstate = S.init_mamba_state(cfg, 3, torch.float32)
    xs = np.random.default_rng(5).standard_normal((8, 3, 1, D_MODEL)).astype(np.float32)
    for x in xs:
        want, jstate = JS.mamba_decode(jcfg, jp, jnp.asarray(x), jstate)
        got, tstate = S.mamba_decode(cfg, tp, torch.from_numpy(x), tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in zip(tstate, jstate):
        assert a.dtype == (torch.float32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_decode_continues_the_forward_pass(params):
    """The recurrence of ``mamba_decode``, fed one token at a time, gives
    the full-sequence ``mamba_forward`` (the plain scan) row by row."""
    _, cfg = configs()
    tp = params[1]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 12, D_MODEL))
                         .astype(np.float32))
    full = S.mamba_forward(cfg, tp, x)
    state = S.init_mamba_state(cfg, 2, torch.float32)
    for t in range(12):
        out, state = S.mamba_decode(cfg, tp, x[:, t:t + 1], state)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(), **TOL)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 100])
def test_assoc_scan_matches_jax_bitwise(n):
    rng = np.random.default_rng(n)
    a = np.exp(-rng.random((2, n, 8, 4))).astype(np.float32)
    b = rng.standard_normal((2, n, 8, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 8, 4)).astype(np.float32)
    for init in (None, h0):
        want = JS._assoc_scan(jnp.asarray(a), jnp.asarray(b),
                              None if init is None else jnp.asarray(init))
        got = S._assoc_scan(torch.from_numpy(a), torch.from_numpy(b),
                            None if init is None else torch.from_numpy(init))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_activations_match_jax():
    """softplus is logaddexp(x, 0) with no threshold; silu is x sigmoid(x)."""
    x = np.linspace(-60, 60, 2401).astype(np.float32)
    np.testing.assert_allclose(S.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(S.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_causal_conv_and_ssm_inputs_match_jax(params):
    jcfg, cfg = configs()
    jp, tp = params
    u = np.random.default_rng(7).standard_normal((2, 10, cfg.d_inner)).astype(np.float32)
    np.testing.assert_allclose(S._causal_conv(tp, torch.from_numpy(u), cfg.ssm_conv).numpy(),
                               np.asarray(JS._causal_conv(jp, jnp.asarray(u), jcfg.ssm_conv)),
                               rtol=1e-6, atol=1e-6)
    for got, want in zip(S._ssm_inputs(cfg, tp, torch.from_numpy(u)),
                         JS._ssm_inputs(jcfg, jp, jnp.asarray(u))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_init_mamba_matches_jax_structure():
    """The port's own init: the reference's keys, shapes and dtypes (bf16
    matrices, float32 conv_b / dt_b / A_log / D), with the deterministic
    leaves equal to the reference's (A_log to an ulp)."""
    jcfg, cfg = configs()
    jp = JS.init_mamba(jax.random.key(1), jcfg, jnp.bfloat16)
    tp = S.init_mamba(torch.Generator().manual_seed(1), cfg, torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        assert str(tp[k].dtype).endswith(str(jp[k].dtype)), k
    for k in ("conv_b", "dt_b", "D"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # log(1..n): the two libraries' logf differ by an ulp at one n
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]), rtol=1e-6, atol=0)
    assert len(tree_leaves(tp)) == 9


# --------------------------------------------------------------------------- #
# the prefill's decode state: from the kernel on the kernel path
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("falcon-mamba-7b").reduced().with_(remat=False)
    jp = JT.init_model(jax.random.key(4), jcfg)
    return jcfg, jp, params_from_numpy(jp, device="cpu")


def _prefill_pair(model, S_, use_pallas, seed=0):
    jcfg, jp, tp = model
    cfg = get_config("falcon-mamba-7b").reduced().with_(remat=False, use_pallas=use_pallas)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S_)).astype(np.int32)
    want, jc = JT.prefill(jcfg.with_(use_pallas=use_pallas), jp, {"tokens": jnp.asarray(toks)})
    got, tc = T.prefill(cfg, tp, {"tokens": torch.from_numpy(toks).long()})
    return cfg, (got, tc), (want, jc)


@pytest.mark.parametrize("S_", [64, 128])
def test_kernel_path_prefill_caches_match_jax(S_, model):
    """The kernel path's caches (the kernel's final state, the conv rows of
    the same ``in_proj`` output) against the reference's prefill caches."""
    cfg, (got, tc), (want, jc) = _prefill_pair(model, S_, True, seed=S_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tc["ssm"].dtype == torch.float32
    assert tuple(tc["ssm"].shape) == (cfg.n_layers, 2, cfg.d_inner, cfg.ssm_state)
    assert tuple(tc["conv"].shape) == (cfg.n_layers, 2, cfg.ssm_conv - 1, cfg.d_inner)
    h = np.asarray(jc["ssm"])
    np.testing.assert_allclose(tc["ssm"].numpy(), h, rtol=0, atol=1e-5 * np.abs(h).max())
    np.testing.assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S_,use_pallas,runs", [
    (64, True, False), (128, True, False), (64, False, True), (37, True, True),
])
def test_tail_state_scan_runs_only_off_the_kernel_path(S_, use_pallas, runs, model,
                                                       monkeypatch):
    """``_mamba_tail_state`` (the plain scan over the whole prompt) is not
    called where the kernel gives the state, and is called once per layer
    on the plain path and at a length that is not a multiple of 64."""
    calls = []
    tail = T._mamba_tail_state

    def counted(*args):
        calls.append(1)
        return tail(*args)

    monkeypatch.setattr(T, "_mamba_tail_state", counted)
    cfg, (got, tc), (want, jc) = _prefill_pair(model, S_, use_pallas, seed=1)
    assert len(calls) == (cfg.n_layers if runs else 0)
    assert S.kernel_path(cfg, S_) == (not runs)
    h = np.asarray(jc["ssm"])
    np.testing.assert_allclose(tc["ssm"].numpy(), h, rtol=0, atol=1e-5 * np.abs(h).max())


@pytest.mark.parametrize("S_", [37, 64, 128])
@pytest.mark.parametrize("d_model", [None, 100])     # d_inner 2 * d_model: 200 is ragged
def test_kernel_path_keeps_the_reference_gate_on_the_cpu(S_, d_model):
    """With no device or on the CPU, ``kernel_path`` is the reference's gate
    (``use_pallas``, S and d_inner multiples of 64,
    ``repro.models.ssm.mamba_mix``); on a CUDA device (a ``torch.device``
    needs no card), and on ``meta`` (the dry run prices the card's route),
    every length and d_inner goes to the kernel with ``use_pallas``, and
    none without."""
    size = {} if d_model is None else {"d_model": d_model}
    on = get_config("falcon-mamba-7b").reduced().with_(use_pallas=True, **size)
    off = on.with_(use_pallas=False)
    jon = jget_config("falcon-mamba-7b").reduced().with_(use_pallas=True, **size)
    assert jon.d_inner == on.d_inner
    reference = S_ % 64 == 0 and jon.d_inner % 64 == 0     # the reference's gate
    assert reference == (S_ != 37 and d_model is None)
    cpu, cuda, meta = torch.device("cpu"), torch.device("cuda"), torch.device("meta")
    assert S.kernel_path(on, S_) == S.kernel_path(on, S_, cpu) == S.kernel_path(on, S_, "cpu")
    assert S.kernel_path(on, S_, cpu) == reference
    assert S.kernel_path(on, S_, cuda) and S.kernel_path(on, S_, "cuda:0")
    assert S.kernel_path(on, S_, meta)
    for dev in (None, cpu, cuda, meta):
        assert not S.kernel_path(off, S_, dev)


@pytest.mark.parametrize("seq", [37, 64])
def test_no_gradient_through_the_scan_kernel_off_the_cpu(seq, params):
    """The kernel has no backward, so off the CPU (``meta`` here, which
    takes the card's route) a scan through it that autograd would
    differentiate raises, rather than leave the mixer's leaves without a
    gradient; without grad, or with no leaf that requires one, it runs.  On
    the CPU the kernel path's plain version is differentiable: its gradient
    is the plain path's."""
    _, cfg = configs(use_pallas=True)
    tp = params[1]
    meta = {k: v.to("meta").requires_grad_() for k, v in tp.items()}
    x = torch.zeros(2, seq, D_MODEL, device="meta")
    with pytest.raises(NotImplementedError, match="no backward"):
        S.mamba_forward(cfg, meta, x)
    with torch.no_grad():
        assert S.mamba_forward(cfg, meta, x).shape == (2, seq, D_MODEL)
    frozen = {k: v.detach() for k, v in meta.items()}
    assert S.mamba_forward(cfg, frozen, x).shape == (2, seq, D_MODEL)

    x = torch.from_numpy(np.random.default_rng(seq).standard_normal((2, seq, D_MODEL))
                         .astype(np.float32))
    grads = []
    for c in (cfg, cfg.with_(use_pallas=False)):
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        S.mamba_forward(c, leaves, x).square().sum().backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    for k, g in grads[1].items():
        assert grads[0][k] is not None and float(g.abs().max()) > 0, k
        np.testing.assert_allclose(grads[0][k].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))


@pytest.mark.parametrize("use_pallas,seq", [(True, 128), (False, 128), (True, 37)])
def test_mamba_prefill_state_only_on_the_kernel_path(use_pallas, seq, params):
    """``mamba_prefill`` gives ``mamba_forward``'s output, and the (conv, ssm)
    state only on the kernel path: the conv state is the prompt's last K-1
    rows of u, the ssm state the last step of the plain recurrence."""
    _, cfg = configs(use_pallas=use_pallas)
    tp = params[1]
    x = torch.from_numpy(np.random.default_rng(seq).standard_normal((2, seq, D_MODEL))
                         .astype(np.float32))
    out, state = S.mamba_prefill(cfg, tp, x)
    assert torch.equal(out, S.mamba_forward(cfg, tp, x))
    if not (use_pallas and seq % 64 == 0):
        assert state is None
        return
    conv, h = state
    u = torch.chunk(x @ tp["in_proj"], 2, dim=-1)[0]
    assert torch.equal(conv, u[:, -(cfg.ssm_conv - 1):])
    deltaA, deltaBu, _ = S._ssm_inputs(cfg, tp, S.silu(S._causal_conv(tp, u, cfg.ssm_conv)))
    want = S._assoc_scan(deltaA, deltaBu)[:, -1]
    np.testing.assert_allclose(h.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
