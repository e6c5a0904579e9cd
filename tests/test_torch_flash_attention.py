"""The port's flash attention (its plain version, on CPU tensors) against the
JAX package's Pallas kernel in interpret mode and against the model's
``_attend``, on the CPU.

Inputs are numpy draws from a seed, in the model's layout (q ``(B, S, H,
hd)``, k and v ``(B, S, KV, hd)``).  The sweep, as small as the reference's
own (``tests/test_kernels.py``): S in {64, 128}, (H, KV) in {(4, 4), (4, 2),
(4, 1)}, hd in {32, 64} and hubert-xlarge's 80, float32 and bfloat16 at the
causal default (hd=80 also without it); and the
features (causal on and off, window {None, 8}, softcap {None, 50}) at each
(H, KV).  Tolerances: float32 outputs within rtol 1e-5 / atol 1e-6 (both
compute in float32, in other summation orders: ~1e-7 apart); bfloat16
outputs, which both round once from float32, within one bf16 ulp of the
reference's value per element, where a value under 1e-3 of the largest
counts as 1e-3 of it (an output that cancels to ~1e-7 from terms of size ~1
keeps only float32's absolute accuracy; measured: 1.1e-8 apart).

The CUDA wrapper's input checks run on CPU tensors too: what the kernel
cannot take raises, and a CPU tensor never reaches the kernel.

The bf16 kernel's rounding (products on the tensor cores, exp in base 2,
probabilities split into two bf16 halves) is emulated in plain PyTorch and
held to the plain version by the same one-bf16-ulp rule; the emulation with
probabilities rounded to bf16 once fails it (~10% of the elements at these
shapes), which shows that the rule guards the split.  The float32 kernel's
arithmetic (q, k, v and P each split into two TF32 halves by rounding, three
TF32 products per matrix product, each accumulator as the kernel has it and
truncated after every k8 step as the tensor cores add) is emulated likewise
and held to the card's float32 rule, 1e-5 of the largest value plus 1e-5 of
the element, against the plain version and the Pallas kernel at every head
width; with one product, or two for S or for P.V, it fails that rule, and
so does O summed in place in one accumulator over a 4096-key row.
``variant`` sends bf16 to the bf16 kernel and float32 to the TF32x3 one, at
every head width of every registered config.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

B = 2


def inputs(S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def both(arrays, dtype, **kw):
    """(port, reference) outputs as float32 numpy arrays."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays), **kw)
    assert got.dtype == tdt and got.shape == arrays[0].shape
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrays), block_q=64,
                                block_k=64, **kw)
    return got.float().numpy(), np.asarray(want, np.float32)


def assert_match(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        mag = np.maximum(np.abs(want), 1e-3 * np.abs(want).max())
        _, e = np.frexp(mag)
        ulp = np.ldexp(1.0, e - 8)          # bf16 keeps 8 significant bits
        assert np.all(np.abs(got - want) <= ulp), float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,hd", [
    (64, 4, 4, 32), (128, 4, 2, 64), (64, 4, 1, 64), (128, 4, 1, 32), (128, 4, 2, 80),
])
def test_flash_matches_pallas_kernel(S, H, KV, hd, dtype):
    assert_match(*both(inputs(S, H, KV, hd), dtype, causal=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_hd80_non_causal_matches_pallas_kernel(dtype):
    """hubert-xlarge's width (head_dim 80) in its encoder's form: no causal
    mask, H = KV."""
    assert_match(*both(inputs(128, 4, 4, 80, seed=5), dtype, causal=False), dtype)


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 8, None), (True, None, 50.0), (False, None, None), (False, 8, 50.0),
])
def test_flash_features_match_pallas_kernel(H, KV, causal, window, softcap):
    got, want = both(inputs(64, H, KV, 32, seed=1), "float32", causal=causal,
                     window=window, softcap=softcap)
    assert_match(got, want, "float32")


@pytest.mark.parametrize("window", [None, 8])
def test_flash_matches_model_attend(window):
    """The plain version agrees with the reference model's ``_attend`` (the
    same masks, scale and softcap: gemma2's 50) on GQA heads."""
    cfg = jget_config("gemma2-2b").reduced().with_(attn_chunk=0)
    H, KV, hd = cfg.n_heads, 2, cfg.head_dim
    q, k, v = inputs(128, H, KV, hd, seed=2)
    pos = jnp.arange(128, dtype=jnp.int32)
    want = JA._attend(cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos,
                      None if window is None else jnp.int32(window), causal=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window,
                              softcap=cfg.attn_softcap)
    np.testing.assert_allclose(got.reshape(B, 128, H * hd).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_cpu_tensors_never_reach_the_kernel():
    q, k, v = (torch.from_numpy(a) for a in inputs(64, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, k, v)
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("change,err", [
    (lambda q, k, v: (q[:, :48], k, v), "multiples of 64"),
    (lambda q, k, v: (q, k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)),
     "multiple of 3 KV heads"),
    (lambda q, k, v: (q[..., :16], k[..., :16], v[..., :16]), "head width 16"),
    (lambda q, k, v: (q.double(), k.double(), v.double()), "dtype"),
    (lambda q, k, v: (q, k, v[:, :64]), "do not fit"),
])
def test_inputs_the_kernel_cannot_take_raise(change, err):
    q, k, v = change(*(torch.from_numpy(a) for a in inputs(128, 4, 2, 32)))
    with pytest.raises((ValueError, TypeError), match=err):
        fa.check_inputs(q, k, v, None, None)


@pytest.mark.parametrize("B_,H", [(1, 65536), (4097, 16)])
def test_inputs_past_65535_heads_are_taken(B_, H):
    """B * H over 65535 goes on the grid's x axis in both kernels: the
    checks take it (only grid sizes the card cannot launch raise)."""
    q = torch.zeros(1, 1, 1, 1).expand(B_, 64, H, 32)     # shapes only: no memory
    k = v = torch.zeros(1, 1, 1, 1).expand(B_, 64, 1, 32)
    fa.check_inputs(q, k, v, None, None)


def test_window_and_softcap_must_be_positive():
    q, k, v = (torch.from_numpy(a) for a in inputs(64, 4, 2, 32))
    with pytest.raises(ValueError, match="window"):
        fa.check_inputs(q, k, v, 0, None)
    with pytest.raises(ValueError, match="softcap"):
        fa.check_inputs(q, k, v, None, 0.0)
    fa.check_inputs(q, k, v, 8, 50.0)


# --------------------------------------------------------------------------- #
# the bf16 tensor-core kernel's rounding, emulated
# --------------------------------------------------------------------------- #
def _logits(q, k, causal, window, softcap, qk):
    """The kernels' logits in plain float32 PyTorch, ``(B, KV, H / KV, Sq,
    Sk)``: S = qk(q, k) scaled after the product (by the float32 of
    1/sqrt(hd) times log2(e)), softcap and mask (masked logits -1e30); ``qk``
    is the kernel's product (einsum's arguments after the equation)."""
    B_, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    log2e = np.float32(1.4426950408889634)
    scale = float(np.float32(np.float32(1.0 / hd ** 0.5) * log2e))
    s = qk("bqgrd,bkgd->bgrqk", q.reshape(B_, Sq, KV, H // KV, hd), k) * scale
    if softcap is not None:
        c = float(np.float32(softcap) * log2e)
        s = c * torch.tanh(s / c)
    rel = torch.arange(Sq)[:, None] - torch.arange(Sk)[None, :]
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    return torch.where(mask, s, torch.full_like(s, -1e30))


def _emulate(q, k, v, causal, window, softcap, qk, pv):
    """The bf16 kernel's arithmetic in plain float32 PyTorch: ``_logits``,
    p = 2^(s - m) in float32 with l summed from the unrounded p, O = pv(p, v)
    / l; ``qk`` and ``pv`` are the kernel's products."""
    B_, Sq, H, hd = q.shape
    s = _logits(q, k, causal, window, softcap, qk)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = pv("bgrqk,bkgd->bgrqd", p, v) / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B_, Sq, H, hd)


def _emulate_tensor_core_kernel(q, k, v, causal=True, window=None, softcap=None, split=True):
    """What the bf16 kernel rounds (a test aid, on no path of the port):
    ``_emulate`` with the bf16 products q.k summed in float32 and p
    multiplied by v as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi),
    summed in float32; ``split=False`` multiplies by bf16(p) alone."""
    def pv(eq, p, v_):
        hi = p.to(torch.bfloat16).float()
        parts = [hi, (p - hi).to(torch.bfloat16).float()] if split else [hi]
        return sum(torch.einsum(eq, x, v_.float()) for x in parts)

    qk = lambda eq, a, b: torch.einsum(eq, a.float(), b.float())       # noqa: E731
    return _emulate(q, k, v, causal, window, softcap, qk, pv).to(torch.bfloat16)


def _bf16_inputs(S, H, KV, hd, seed):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in inputs(S, H, KV, hd, seed)]


def _out_of_tolerance(got, want):
    """Share of elements more than one bf16 ulp (floor 1e-3 of the largest)
    from the plain version: ``assert_match``'s rule, which the card's check
    (``attn_agree`` in chip_smoke.py) also applies."""
    got, want = got.float().numpy(), want.float().numpy()
    mag = np.maximum(np.abs(want), 1e-3 * np.abs(want).max())
    _, e = np.frexp(mag)
    return float(np.mean(np.abs(got - want) > np.ldexp(1.0, e - 8)))


@pytest.mark.parametrize("S,hd,window,softcap", [
    (256, 128, None, None), (256, 64, None, None), (128, 256, None, None),
    (256, 128, 100, None), (192, 64, None, 50.0), (128, 256, 64, 50.0),
    (256, 80, None, None), (192, 80, 100, 50.0),
])
def test_split_probabilities_meet_the_bf16_check(S, hd, window, softcap):
    """P split into two bf16 halves keeps the kernel within one bf16 ulp of
    the plain version: the design's premise, held at small shapes."""
    q, k, v = _bf16_inputs(S, 4, 2, hd, seed=3)
    want = ref.ref_flash_attention(q, k, v, True, window, softcap)
    got = _emulate_tensor_core_kernel(q, k, v, True, window, softcap)
    assert_match(got.float().numpy(), want.float().numpy(), "bfloat16")


@pytest.mark.parametrize("S,hd", [(256, 128), (256, 64), (128, 256), (256, 80)])
def test_unsplit_bf16_probabilities_fail_the_check(S, hd):
    """Control: P rounded to bf16 once puts many elements outside one bf16
    ulp (~10% at these shapes), so the check guards the split."""
    q, k, v = _bf16_inputs(S, 4, 4, hd, seed=4)
    want = ref.ref_flash_attention(q, k, v)
    assert _out_of_tolerance(_emulate_tensor_core_kernel(q, k, v), want) == 0.0
    assert _out_of_tolerance(_emulate_tensor_core_kernel(q, k, v, split=False), want) > 0.02


# --------------------------------------------------------------------------- #
# the float32 kernel's TF32 products, emulated
# --------------------------------------------------------------------------- #
def _tf32(x):
    """``cvt.rna.tf32.f32`` on the bits: the 10-bit mantissa rounded to
    nearest, ties away from zero (sign and magnitude, so adding half an ulp
    of the kept bits to the bits rounds both signs), the low 13 bits 0."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


# the float32 kernel's key tile by head width (``Cfg<HD>::kBN`` of namespace
# tf32x3 in flash_attention.cu): the keys of one fresh P.V accumulator
_KEY_TILE = {32: 64, 64: 64, 80: 64, 96: 32, 128: 32, 256: 8}


def _halves(x):
    """TF32 halves, hi = tf32(x) and lo = tf32(x - hi), as the kernel's
    split forms them."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _truncate(x):
    """float64 to float32 rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _wgmma(eq, terms, acc=None):
    """A tensor-core accumulator as ``wgmma`` adds into it: ``acc`` (float32;
    zeros if None) plus each TF32 product (a, b) of ``terms`` in turn, in k8
    steps over the contracted axis (the last of both operands); each step's
    eight products and the accumulator summed exactly and truncated to
    float32.  The truncation is the tensor cores' (round toward zero), which
    round-to-nearest einsums cannot show."""
    for a, b in terms:
        for c in range(0, a.shape[-1], 8):
            part = torch.einsum(eq, a[..., c:c + 8].double(), b[..., c:c + 8].double())
            acc = _truncate(part if acc is None else acc.double() + part)
    return acc


def _emulate_tf32x3_kernel(q, k, v, causal=True, window=None, softcap=None, s_terms=3,
                           pv_terms=3, o_in_place=False):
    """What the float32 kernel computes (a test aid, on no path of the
    port), accumulator by accumulator.  S: Q_lo K_hi then Q_hi K_hi in one
    ``_wgmma`` accumulator, Q_hi K_lo in another, the halves summed in
    float32.  Then ``_logits``' scale, softcap and mask, and the online
    softmax over key tiles of ``_KEY_TILE[hd]``: tile j's P_lo V_hi, P_hi
    V_lo, P_hi V_hi in a fresh accumulator, which O takes with rounded
    float32 adds one tile later, O = (O + PV_{j-1}) * alpha_j.
    ``s_terms`` / ``pv_terms`` < 3 drop products from the front (2: no
    Q_lo K_hi or P_lo V_hi; 1: hi*hi alone); ``o_in_place`` sums P.V into O
    itself, truncating, with O times alpha rounded in between."""
    B_, Sq, H, hd = q.shape
    Sk = k.shape[1]
    bn = _KEY_TILE[hd]

    def qk(eq, q_, k_):
        (qh, ql), (kh, kl) = _halves(q_), _halves(k_)
        s = _wgmma(eq, [(ql, kh), (qh, kh)][s_terms < 3:])
        return s + _wgmma(eq, [(qh, kl)]) if s_terms > 1 else s

    s = _logits(q, k, causal, window, softcap, qk)
    vh, vl = _halves(v.permute(0, 2, 3, 1))          # V^T: (B, KV, hd, Sk)
    eq = "bgrqk,bgdk->bgrqd"
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + (hd,))
    pv = None
    for k0 in range(0, Sk, bn):
        tile = s[..., k0:k0 + bn]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        alpha, p, m = torch.exp2(m - m_new), torch.exp2(tile - m_new), m_new
        l = l * alpha + p.sum(-1, keepdim=True)
        (ph, pl), vth, vtl = _halves(p), vh[..., k0:k0 + bn], vl[..., k0:k0 + bn]
        terms = [(pl, vth), (ph, vtl), (ph, vth)][3 - pv_terms:]
        if o_in_place:
            o = _wgmma(eq, terms, o * alpha)
            continue
        if pv is not None:
            o = (o + pv) * alpha
        pv = _wgmma(eq, terms)
    if not o_in_place:
        o = o + pv
    o = o / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B_, Sq, H, hd)


def _f32_share(got, want):
    """The largest error as a share of the card's float32 tolerance,
    ``1e-5 * max|want| + 1e-5 * |want|`` (``attn_agree`` in chip_smoke.py);
    at most 1 passes."""
    want = torch.as_tensor(want)
    tol = 1e-5 * want.abs().max() + 1e-5 * want.abs()
    return float(((torch.as_tensor(got) - want).abs() / tol).max())


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 48, 50.0), (False, None, None),
])
def test_tf32x3_products_meet_the_float32_check(hd, causal, window, softcap):
    """Three TF32 products per matrix product keep the float32 kernel within
    the card's float32 rule of the plain version and of the Pallas kernel
    (interpret mode): the design's premise, at every head width."""
    arrays = inputs(128, 4, 2, hd, seed=6)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = _emulate_tf32x3_kernel(q, k, v, causal, window, softcap)
    want = ref.ref_flash_attention(q, k, v, causal, window, softcap)
    pallas = np.array(jops.flash_attention(*(jnp.asarray(a) for a in arrays), block_q=64,
                                           block_k=64, causal=causal, window=window,
                                           softcap=softcap))
    assert _f32_share(got, want) <= 1.0
    assert _f32_share(got, pallas) <= 1.0


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("s_terms,pv_terms", [(1, 1), (2, 3), (3, 2)])
def test_fewer_tf32_products_fail_the_float32_check(hd, s_terms, pv_terms):
    """Control: one TF32 product per matrix product, or two for S or for
    P.V, puts the output outside the float32 rule (by several times), so
    the check guards each of the three."""
    q, k, v = (torch.from_numpy(a) for a in inputs(256, 4, 2, hd, seed=7))
    want = ref.ref_flash_attention(q, k, v)
    assert _f32_share(_emulate_tf32x3_kernel(q, k, v), want) <= 1.0
    assert _f32_share(_emulate_tf32x3_kernel(q, k, v, s_terms=s_terms, pv_terms=pv_terms),
                      want) > 2.0


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_o_summed_in_place_fails_on_a_long_row(hd):
    """Control: O summed in place in the truncating accumulator drifts
    towards zero over a long row without a causal mask (64 queries, 4096
    keys) and fails the float32 rule; a fresh accumulator per key tile, as
    the kernel has, holds it.  The check guards the per-tile P.V."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, n, hd)).astype(np.float32))
               for S, n in ((64, 2), (4096, 1), (4096, 1)))
    want = ref.ref_flash_attention(q, k, v, False)
    assert _f32_share(_emulate_tf32x3_kernel(q, k, v, False), want) <= 1.0
    assert _f32_share(_emulate_tf32x3_kernel(q, k, v, False, o_in_place=True), want) > 1.5


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_variant_follows_dtype(hd):
    assert fa.variant(torch.bfloat16, hd) == "wgmma"
    assert fa.variant(torch.float32, hd) == "tf32x3"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_head_width_has_a_kernel(arch):
    """Each registered config's head width (0 for a pure SSM, which has no
    attention) is one the kernels take, in both variants."""
    hd = get_config(arch).head_dim
    if hd == 0:
        assert get_config(arch).arch_type == "ssm"
        return
    assert hd in fa.HEAD_DIMS
    assert fa.variant(torch.bfloat16, hd) == "wgmma"
    assert fa.variant(torch.float32, hd) == "tf32x3"


def test_variant_rejects_what_no_kernel_takes():
    with pytest.raises(TypeError, match="dtype"):
        fa.variant(torch.float16, 128)
    with pytest.raises(ValueError, match="head width"):
        fa.variant(torch.bfloat16, 48)


def test_launch_counters_name_every_variant():
    assert set(fa.LAUNCHES) == {"flash_attention"} | {
        f"flash_attention_{fa.variant(dt, 128)}" for dt in fa.DTYPES} | {
        f"flash_attention_hd{hd}" for hd in fa.HEAD_DIMS}
