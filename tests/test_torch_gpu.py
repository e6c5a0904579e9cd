"""The port's CUDA kernels on the card (skipped without a CUDA device).

Run on a GPU machine from the repository root with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX (the GPU machine has none): each kernel is held
against its plain PyTorch version on the same inputs.  Per-leaf kernels: fp32
outputs bitwise, bf16 ones to one bf16 ulp, the sum of squares to rtol
1e-6 (also where the counters wrap past 2^32, and over a split leaf);
zo_perturb also on views off a 16-byte boundary.  zo_reconstruct_update,
zo_reconstruct_flat and zo_perturb_flat are held bit for bit at every m, at
blocks of 256, 257 and 4096 and off 16-byte boundaries.  The Gaussian is
held to libdevice's on every value of its two uniforms.  Other flat kernels: fp32 outputs to
rtol 1e-5 / atol 1e-6 (the two differ at most by ulps of logf/cosf and by
the order of the sum of squares) and bf16-rounded outputs to one bf16 ulp
per element with at most 0.1% of the elements differing at all; an fp32
accumulator fails that check.  Flash attention is held to its plain version
in float32 to rtol 1e-5 / atol 1e-5 and in bf16 to one bf16 ulp per element
(values under 1e-3 of the largest count as 1e-3 of it): both compute in
float32 in other summation orders and round once.  The selective scan and
RMSNorm are held the same way in bf16, and in float32 to 1e-4 of the
largest output value (the kernel sums over the state axis, and over a row,
in another order than the plain version).  The scan's final state is held
to 1e-5 of max|h|: each h rounds as the plain version's does (the same
float32 operations in the same order), so only the two libraries' expf may
part them, by an ulp; a state one step early fails that check.  Past
element 2^31 of a packed buffer, zo_perturb_flat (rtol 1e-5 / atol 1e-6)
and zo_reconstruct_flat (bit for bit) are held on the blocks around that
element and the last 64.  A checkpoint of card tensors restores bit for
bit on the card, its manifest the bytes msgpack writes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import zo_direction as cu
from torch_flat_helpers import bf16_match, flat_meta, leaf, multi_salts, packed, to_t

FP32_TOL = dict(rtol=1e-5, atol=1e-6)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(acc_dtype):
    """On the card: every kernel against its plain version on the same
    inputs (run on a GPU machine with ``pytest -m gpu``)."""
    dev = _cuda()
    sizes, block, m = [1000, 261, 1], 256, 4
    salts1, ctrs, nvalid = (to_t(a).to(dev) for a in flat_meta(sizes, block))
    msalts = to_t(multi_salts(salts1.cpu().numpy(), m, 613)).to(dev)
    bf16 = torch.tensor([0, 0, 0, 0, 1, 1, 0], dtype=torch.int32, device=dev)
    bfe = (bf16 != 0).repeat_interleave(block)
    coeffs = torch.tensor([0.25, -0.75, 1.5, 0.3], device=dev)
    x = to_t(packed(sizes, block)).to(dev)
    torch.testing.assert_close(cu.zo_perturb_flat(x, salts1, ctrs, nvalid, 0.01, block),
                               ref.ref_zo_perturb_flat(x, salts1, ctrs, nvalid, 0.01, block),
                               **FP32_TOL)
    got = cu.zo_reconstruct_flat(msalts, coeffs, ctrs, nvalid, block, acc_dtype)
    want = ref.ref_zo_reconstruct_flat(msalts, coeffs, ctrs, nvalid, block, acc_dtype)
    assert torch.equal(got, want)
    if acc_dtype == "bfloat16":
        # control: the fp32 accumulator's output fails even the bf16 check
        assert not bf16_match(
            ref.ref_zo_reconstruct_flat(msalts, coeffs, ctrs, nvalid, block), want)
    out, ss = cu.zo_perturb_sumsq(x, salts1, ctrs, nvalid, 1e-3, block)
    want, wss = ref.ref_zo_perturb_sumsq(x, salts1, ctrs, nvalid, 1e-3, block)
    torch.testing.assert_close(ss, wss, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(out, want, **FP32_TOL)
    # at mu = sqrt(d) the perturbation is O(1): compare it, not the sum
    mu1 = float(np.sqrt(sum(sizes)))
    out1, _ = cu.zo_perturb_sumsq(x, salts1, ctrs, nvalid, mu1, block)
    want1, _ = ref.ref_zo_perturb_sumsq(x, salts1, ctrs, nvalid, mu1, block)
    torch.testing.assert_close(out1 - x, want1 - x, **FP32_TOL)
    for momentum in (0.0, 0.9):
        mom = None if momentum == 0.0 else torch.full_like(x, 0.1)
        p_k, m_k = cu.zo_reconstruct_update(x.clone(), None if mom is None else mom.clone(),
                                            msalts, ctrs, nvalid, bf16, coeffs, 0.05,
                                            momentum, block, acc_dtype)
        p_r, m_r = ref.ref_zo_reconstruct_update(x, mom, msalts, ctrs, nvalid, bf16,
                                                 coeffs, 0.05, momentum, block, acc_dtype)
        torch.testing.assert_close(p_k[~bfe], p_r[~bfe], **FP32_TOL)
        assert bf16_match(p_k[bfe], p_r[bfe])
        if mom is not None:
            torch.testing.assert_close(m_k, m_r, **FP32_TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_flat_engine_step_on_card_matches_fused(momentum):
    """HO-SGD through the kernels (engine='flat') against the plain
    engine on the card, on a small MLP with SGD at this momentum: same
    FO/ZO order and losses to rtol 1e-4."""
    from repro_torch.apps.classification import load_dataset
    from repro_torch.core.ho_sgd import HOSGDConfig, make_ho_sgd, run_method
    from repro_torch.data.synthetic import batches
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss

    dev = _cuda()
    ds = load_dataset("covtype")
    p0 = init_mlp_classifier(torch.Generator().manual_seed(0), ds.n_features,
                             ds.n_classes, hidden=64, device=dev)
    d = sum(p.numel() for p in p0.values())
    hist = {}
    for engine in ("flat", "fused"):
        cfg = HOSGDConfig(tau=4, mu=1e-3, m=4, lr=0.05, zo_lr=0.05 * 30.0 / d,
                          momentum=momentum, engine=engine)
        hist[engine] = run_method(make_ho_sgd(mlp_loss, cfg), p0,
                                  batches(ds, 4 * 16, seed=1), 8)
    assert hist["flat"]["order"] == hist["fused"]["order"]
    np.testing.assert_allclose(hist["flat"]["loss"], hist["fused"]["loss"], rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 37, 4097, 70200])
@pytest.mark.parametrize("offset", [0, 12345])
def test_per_leaf_kernels_match_plain_versions(n, offset):
    """zo_perturb (float32 bitwise, bfloat16 within one bf16 ulp),
    zo_reconstruct (float32 bitwise, bfloat16 accumulator within one bf16
    ulp, which a float32 accumulator fails), zo_sumsq (rtol 1e-6, the same
    run to run) and no store past the leaf."""
    dev = _cuda()
    x = to_t(leaf(n)).to(dev)
    scale = torch.tensor(0.37, device=dev)
    assert torch.equal(cu.zo_perturb(x, 99, scale, offset),
                       ref.ref_zo_perturb(x, 99, scale, offset))
    xb = x.to(torch.bfloat16)
    got = cu.zo_perturb(xb, 99, scale, offset)
    assert got.dtype == torch.bfloat16
    assert bf16_match(got, ref.ref_zo_perturb(xb, 99, scale, offset))
    for m in (1, 4):
        salts = torch.arange(11, 11 + m, dtype=torch.int32).to(torch.uint32).to(dev)
        coeffs = torch.linspace(-1.5, 2.0, m, device=dev)
        want = {acc: ref.ref_zo_reconstruct(n, salts.cpu(), coeffs, offset, acc, device=dev)
                for acc in ("float32", "bfloat16")}
        assert torch.equal(cu.zo_reconstruct(n, salts, coeffs, offset), want["float32"])
        assert bf16_match(cu.zo_reconstruct(n, salts, coeffs, offset, "bfloat16"),
                          want["bfloat16"])
        if m == 4 and n > 1000:
            assert not bf16_match(want["float32"], want["bfloat16"])
    ss = cu.zo_sumsq(n, 99, offset, dev)
    torch.testing.assert_close(ss, ref.ref_zo_sumsq(n, 99, offset, device=dev),
                               rtol=1e-6, atol=0.0)
    assert torch.equal(ss, cu.zo_sumsq(n, 99, offset, dev))
    # the masked tail: a canary after the leaf in the same allocation
    buf = torch.full((n + 256,), 7.0, device=dev)
    cu._launch("zo_perturb", "zo_perturb_leaf_launch", x.data_ptr(), buf.data_ptr(), n,
               99, offset, scale.reshape(1).data_ptr(), 0, x.device.index,
               torch.cuda.current_stream(x.device).cuda_stream)
    assert torch.equal(buf[:n], ref.ref_zo_perturb(x, 99, scale, offset))
    assert bool((buf[n:] == 7.0).all())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 5, 4097, 70201, 1690001])
@pytest.mark.parametrize("shift", [1, 3])
def test_zo_perturb_on_views_off_a_16_byte_boundary(n, shift):
    """zo_perturb on ``x[shift:]`` (4 * shift bytes past a boundary): float32
    bitwise, bfloat16 within one bf16 ulp.  Leaves past one lane per thread
    of the whole card take 16-byte vectors after a scalar head and before a
    scalar tail; nothing is stored past the leaf."""
    dev = _cuda()
    base = to_t(leaf(n + shift + 1)).to(dev)
    scale = torch.tensor(0.37, device=dev)
    for xs in (base, base.to(torch.bfloat16)):
        x = xs[shift:shift + n]
        got, want = cu.zo_perturb(x, 7, scale, 12345), ref.ref_zo_perturb(x, 7, scale, 12345)
        assert got.dtype == x.dtype and got.shape == x.shape
        if x.dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            assert bf16_match(got, want)
    # a caller's buffer at a boundary and one value past it (then x's and the
    # buffer's alignments differ), with canaries around the leaf
    x = base[:n]
    for at in (0, 1):
        buf = torch.full((n + 257,), 7.0, device=dev)
        cu._launch("zo_perturb", "zo_perturb_leaf_launch", x.data_ptr(), buf[at:].data_ptr(),
                   n, 7, 0, scale.reshape(1).data_ptr(), 0, x.device.index,
                   torch.cuda.current_stream(x.device).cuda_stream)
        assert torch.equal(buf[at:at + n], ref.ref_zo_perturb(x, 7, scale, 0))
        assert bool((buf[:at] == 7.0).all()) and bool((buf[at + n:] == 7.0).all())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,block,shift", [
    ([1000, 261, 1, 5], 257, 0), ([1000, 261, 1, 5], 257, 1),
    ([4096 * 4096 - 5], 4096, 0), ([4096 * 4096 - 5], 4096, 3)])
def test_zo_perturb_sumsq_ragged_blocks_and_past_the_l2(sizes, block, shift):
    """zo_perturb_sumsq at a block that is not a multiple of 4 and on a
    buffer past the L2 (4096 blocks of 4096), each also starting off a
    16-byte boundary: sum v^2 to rtol 1e-5 of the plain version, the output
    to FP32_TOL, and both bitwise the same run to run."""
    dev = _cuda()
    salts, ctrs, nvalid = (to_t(a).to(dev) for a in flat_meta(sizes, block))
    x = torch.cat([torch.zeros(shift), to_t(packed(sizes, block))]).to(dev)[shift:]
    out, ss = cu.zo_perturb_sumsq(x, salts, ctrs, nvalid, 1e-3, block)
    want, wss = ref.ref_zo_perturb_sumsq(x, salts, ctrs, nvalid, 1e-3, block)
    torch.testing.assert_close(ss, wss, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(out, want, **FP32_TOL)
    out2, ss2 = cu.zo_perturb_sumsq(x, salts, ctrs, nvalid, 1e-3, block)
    assert torch.equal(out, out2) and torch.equal(ss, ss2)
    torch.cuda.synchronize()


def _random_layout(block, n_min=300_000, m=8, seed=0):
    """A packed layout past one lane per thread of the whole card (so the
    kernels take 16-byte vectors): random salts (n_blocks, m), counters
    (wrapping), valid lanes (three blocks in four full) and one block in 8
    bf16, on the card."""
    rng = np.random.default_rng(seed)
    nb = -(-n_min // block)
    nv = np.where(rng.random(nb) < 0.75, block, rng.integers(1, block + 1, nb)).astype(np.int32)
    ctrs = rng.integers(0, 2 ** 32, nb, dtype=np.uint64).astype(np.uint32)
    salts = rng.integers(0, 2 ** 32, (nb, m), dtype=np.uint64).astype(np.uint32)
    bf16 = (rng.random(nb) < 0.125).astype(np.int32)
    return [to_t(a).to(_cuda()) for a in (salts, ctrs, nv, bf16)]


def _at(x, shift):
    """A copy of x whose data starts ``shift`` values past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    return buf[shift:shift + x.numel()].copy_(x)


@pytest.mark.gpu
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [256, 257, 4096])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
def test_zo_reconstruct_update_matches_plain_version(m, block, acc_dtype, momentum):
    """zo_reconstruct_update at the worker counts the repository's methods
    use (1, 2, 4, 5, 8) and another (3), at blocks of 256, 257 (vectors crossing
    blocks' edges) and 4096 with random valid lanes and bf16 blocks, p and
    mom at a 16-byte boundary and 4 bytes past one: bit for bit the plain
    version (the same float32 operations in the same order)."""
    dev = _cuda()
    salts, ctrs, nvalid, bf16 = _random_layout(block, seed=block + m)
    sm = salts[:, :m].contiguous()
    coeffs = torch.tensor([0.5, -1.0, 2.0, 0.1, 0.7, -0.3, 1.2, -0.8][:m], device=dev)
    x = torch.randn(salts.shape[0] * block, generator=torch.Generator().manual_seed(m)).to(dev)
    mom = None if momentum == 0.0 else torch.full_like(x, 0.1)
    p_r, m_r = ref.ref_zo_reconstruct_update(x, mom, sm, ctrs, nvalid, bf16, coeffs, 0.05,
                                             momentum, block, acc_dtype)
    for shift in (0, 1):
        p_k = _at(x, shift)
        m_k = None if mom is None else _at(mom, shift)
        cu.zo_reconstruct_update(p_k, m_k, sm, ctrs, nvalid, bf16, coeffs, 0.05, momentum,
                                 block, acc_dtype)
        assert torch.equal(p_k, p_r)
        if mom is not None:
            assert torch.equal(m_k, m_r)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [256, 257, 4096])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
def test_zo_reconstruct_flat_matches_plain_version(m, block, acc_dtype):
    """zo_reconstruct_flat (zo_reconstruct_update's kernel with a store for
    the commit) at the same m and blocks, random valid lanes: bit for bit
    the plain version, padding lanes 0; launched into a caller's buffer one
    value past a 16-byte boundary (a scalar head), with canaries of 256
    values around it that stay untouched."""
    dev = _cuda()
    salts, ctrs, nvalid, _ = _random_layout(block, seed=3 * block + m)
    sm = salts[:, :m].contiguous()
    coeffs = torch.tensor([0.5, -1.0, 2.0, 0.1, 0.7, -0.3, 1.2, -0.8][:m], device=dev)
    want = ref.ref_zo_reconstruct_flat(sm, coeffs, ctrs, nvalid, block, acc_dtype)
    assert torch.equal(cu.zo_reconstruct_flat(sm, coeffs, ctrs, nvalid, block, acc_dtype), want)
    n = want.numel()
    buf = torch.full((n + 512,), 7.0, device=dev)
    out = buf[257:]                        # one value past a 16-byte boundary
    cu._launch("zo_reconstruct_flat", "zo_reconstruct_flat_launch", sm.data_ptr(),
               coeffs.data_ptr(), ctrs.data_ptr(), nvalid.data_ptr(), out.data_ptr(), n, block,
               m, int(acc_dtype == "bfloat16"), buf.device.index, cu._stream(buf.device))
    assert torch.equal(out[:n], want)
    assert bool((buf[:257] == 7.0).all()) and bool((out[n:] == 7.0).all())
    torch.cuda.synchronize()


WRAP = 2 ** 32 - 1000          # counters offset + i wrap past 2^32 inside a leaf


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 12345, WRAP])
@pytest.mark.parametrize("n", [1, 3, 7, 4095, 4097, 70200, 1_690_000])
def test_zo_sumsq_matches_plain_version(n, offset):
    """zo_sumsq (a grid from occupancy, eight Gaussians a thread a trip, the
    partials summed by a dependent launch) within rtol 1e-6 of the plain
    sum, and bitwise the same run to run."""
    dev = _cuda()
    got = cu.zo_sumsq(n, 0x2545F491, offset, dev)
    assert got.shape == () and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.ref_zo_sumsq(n, 0x2545F491, offset, device=dev),
                               rtol=1e-6, atol=0.0)
    assert torch.equal(got, cu.zo_sumsq(n, 0x2545F491, offset, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, WRAP])
def test_zo_sumsq_over_a_split_leaf(offset):
    """Two calls over a leaf cut at k (the second at offset + k, mod 2^32)
    sum to one call within rtol 1e-6; at WRAP the first part's counters
    wrap."""
    dev = _cuda()
    n, k = 1_690_000, 1_234_567
    parts = cu.zo_sumsq(k, 77, offset, dev) + cu.zo_sumsq(n - k, 77, (offset + k) % 2 ** 32, dev)
    torch.testing.assert_close(parts, cu.zo_sumsq(n, 77, offset, dev), rtol=1e-6, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("block", [256, 257, 4096])
def test_zo_perturb_flat_matches_plain_version(block, shift):
    """zo_perturb_flat on x at ``shift`` values past a 16-byte boundary:
    bit for bit the plain version; launched into a caller's buffer at x's
    alignment and at another one, with canaries of 256 values around it that
    stay untouched."""
    dev = _cuda()
    salts, ctrs, nvalid, _ = _random_layout(block, seed=block)
    s1 = salts[:, 0].contiguous()
    n = salts.shape[0] * block
    x = _at(torch.randn(n, generator=torch.Generator().manual_seed(block)).to(dev), shift)
    want = ref.ref_zo_perturb_flat(x, s1, ctrs, nvalid, 0.01, block)
    got = cu.zo_perturb_flat(x, s1, ctrs, nvalid, 0.01, block)
    assert got.data_ptr() % 16 == x.data_ptr() % 16
    assert torch.equal(got, want)
    scale = torch.tensor([0.01], device=dev)
    for at in (shift, (shift + 1) % 4):
        buf = torch.full((n + 512,), 7.0, device=dev)
        out = buf[256 + at:]               # `at` values past a 16-byte boundary
        cu._launch("zo_perturb_flat", "zo_perturb_flat_launch", x.data_ptr(), s1.data_ptr(),
                   ctrs.data_ptr(), nvalid.data_ptr(), scale.data_ptr(), out.data_ptr(), n,
                   block, x.device.index, cu._stream(x.device))
        assert torch.equal(out[:n], want)
        assert bool((buf[:256 + at] == 7.0).all())
        assert bool((out[n:] == 7.0).all())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_zo_reconstruct_update_takes_lr_by_value():
    """lr as a float and as a CPU float32 tensor (a schedule's value) give
    the same update; a tensor on the card raises TypeError (no sync)."""
    dev = _cuda()
    salts, ctrs, nvalid, bf16 = _random_layout(4096, n_min=100_000)
    sm = salts[:, :4].contiguous()
    coeffs = torch.tensor([0.25, -0.75, 1.5, 0.3], device=dev)
    x = torch.randn(salts.shape[0] * 4096, generator=torch.Generator().manual_seed(3)).to(dev)
    outs = []
    for lr in (0.05, torch.tensor(0.05, dtype=torch.float32)):
        p = x.clone()
        cu.zo_reconstruct_update(p, None, sm, ctrs, nvalid, bf16, coeffs, lr, 0.0, 4096)
        outs.append(p)
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(TypeError, match="lr: taken by value"):
        cu.zo_reconstruct_update(x.clone(), None, sm, ctrs, nvalid, bf16, coeffs,
                                 torch.tensor(0.05, device=dev), 0.0, 4096)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gauss_is_libdevice_on_every_uniform():
    """The kernels' Gaussian against libdevice's logf/sqrtf/cosf on all 2^24
    values of each uniform, taken as the reference computes it: none
    differs; the control (cosf one ulp further on) differs."""
    dev = _cuda()
    assert cu.check_gauss(dev) == (0, 0)
    assert cu.check_gauss(dev, control=True)[1] > 0


@pytest.mark.gpu
def test_pallas_engine_step_on_card_matches_fused():
    """HO-SGD through the per-leaf kernels (engine='pallas') against the
    plain engine on the card: same FO/ZO order and losses to rtol 1e-4."""
    from repro_torch.apps.classification import load_dataset
    from repro_torch.core.ho_sgd import HOSGDConfig, make_ho_sgd, run_method
    from repro_torch.data.synthetic import batches
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss

    dev = _cuda()
    ds = load_dataset("covtype")
    p0 = init_mlp_classifier(torch.Generator().manual_seed(0), ds.n_features,
                             ds.n_classes, hidden=64, device=dev)
    d = sum(p.numel() for p in p0.values())
    hist = {}
    for engine in ("pallas", "fused"):
        cfg = HOSGDConfig(tau=4, mu=1e-3, m=4, lr=0.05, zo_lr=0.05 * 30.0 / d, engine=engine)
        hist[engine] = run_method(make_ho_sgd(mlp_loss, cfg), p0,
                                  batches(ds, 4 * 16, seed=1), 8)
    assert hist["pallas"]["order"] == hist["fused"]["order"]
    np.testing.assert_allclose(hist["pallas"]["loss"], hist["fused"]["loss"], rtol=1e-4)


def _attn_close(got, want):
    got, want = got.float(), want.float()
    mag = torch.maximum(want.abs(), 1e-3 * want.abs().max())
    _, e = torch.frexp(mag)
    return bool(((got - want).abs() <= torch.ldexp(torch.ones_like(mag), e - 8)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,hd,causal,window,softcap", [
    (128, 8, 2, 128, True, None, None),    # qwen3-style GQA
    (192, 4, 2, 256, True, 64, 50.0),      # gemma2: window and softcap
    (256, 4, 2, 256, False, 100, 50.0),    # hd=256, no causal mask: float32's 8-key tiles
    (128, 4, 4, 96, True, None, None),     # phi3's head width
    (64, 4, 1, 64, False, None, None),
    (128, 4, 2, 32, True, 8, None),        # reduced() configs
    (128, 4, 4, 80, False, None, None),    # hubert-xlarge's head width, its encoder's mask
    (192, 4, 2, 80, True, None, None),
    (64, 8, 2, 128, True, None, None),     # a 128-row tile half past Sq
    (576, 4, 2, 128, True, None, None),    # the last tile half past Sq
    ((128, 512), 4, 2, 128, True, None, None),    # Sq != Sk
    ((128, 512), 4, 2, 64, False, None, None),
    (256, 64, 4, 128, True, None, None),   # qwen3-moe-235b-a22b: 16 query heads per KV head
    (1024, 16, 16, 80, False, None, None),  # hubert-xlarge's encoder at its model shape
])
def test_flash_attention_kernel_matches_plain_version(S, H, KV, hd, causal, window,
                                                       softcap, dtype):
    from repro_torch.kernels import flash_attention as fa

    dev = _cuda()
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, Sq, H, hd, generator=g).to(dev, dtype)
    k, v = (torch.randn(2, Sk, KV, hd, generator=g).to(dev, dtype) for _ in range(2))
    name = f"flash_attention_{fa.variant(dtype, hd)}"
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal, window, softcap)
    launched = {c: n - before[c] for c, n in fa.LAUNCHES.items() if n != before[c]}
    assert launched == {"flash_attention": 1, name: 1, f"flash_attention_hd{hd}": 1}
    assert name == ("flash_attention_wgmma" if dtype == torch.bfloat16 else
                    "flash_attention_tf32x3")
    want = ref.ref_flash_attention(q, k, v, causal, window, softcap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _attn_close(got, want)
    # control: the KV head h % KV instead of h // (H // KV) fails the check
    if KV not in (1, H):
        wrong = ref.ref_flash_attention(q, k[:, :, torch.arange(H) % KV],
                                        v[:, :, torch.arange(H) % KV], causal, window,
                                        softcap)
        assert not _attn_close(wrong, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_past_65535_heads(dtype):
    """B * H = 70,400 blocks of heads (the grid's x axis in both kernels),
    S=64, hd=32: the kernel against its plain version."""
    from repro_torch.kernels import flash_attention as fa

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(1100, 64, 64, 32, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(1100, 64, 8, 32, generator=g, device=dev).to(dtype) for _ in range(2))
    got = fa.flash_attention(q, k, v, True)
    want = ref.ref_flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _attn_close(got, want)


@pytest.mark.gpu
def test_flash_attention_rejects_what_it_cannot_take():
    from repro_torch.kernels import flash_attention as fa

    dev = _cuda()
    q = torch.randn(1, 128, 4, 128, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, 128, 2, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :100], k[:, :100], k[:, :100])   # not a multiple of 64
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.float(), k)


@pytest.mark.gpu
def test_model_prefill_through_the_kernel_matches_plain_path():
    """qwen3-14b.reduced() with a GQA variant, in bf16, prefilled on the card
    through the kernel (use_pallas) and through the plain path: the kernel
    launches once per layer and the logits agree to 2% of their largest."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    dev = _cuda()
    cfg = get_config("qwen3-14b").reduced().with_(n_kv_heads=2, dtype="bfloat16")
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=torch.Generator().manual_seed(1))
    toks, last = toks.to(dev), torch.tensor([100], device=dev)
    ops.reset_launch_counts()
    fast, _ = T.prefill_at(cfg.with_(use_pallas=True), params, {"tokens": toks}, last)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    plain, _ = T.prefill_at(cfg, params, {"tokens": toks}, last)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    torch.cuda.synchronize()
    err = float((fast.float() - plain.float()).abs().max())
    assert err <= 0.02 * float(plain.float().abs().max()), err


@pytest.mark.gpu
def test_serving_on_card_samples_independently_of_slots():
    """The serving engine on the card at temperature 1 (CUDA generators from
    fold(seed, request, step)): 1 slot and 3 slots give the same tokens, and
    the aligned prefills launch the kernel once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, ServeConfig

    dev = _cuda()
    cfg = get_config("qwen3-14b").reduced().with_(dtype="bfloat16", use_pallas=True)
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in (70, 5, 100)]
    outs = []
    for slots in (1, 3):
        ops.reset_launch_counts()
        eng = Engine(cfg, params, ServeConfig(max_seq=160, slots=slots, temperature=1.0))
        outs.append(eng.generate(prompts, max_new=6, key=7))
        assert ops.launch_counts()["flash_attention"] == 2 * cfg.n_layers
    assert outs[0] == outs[1]


def _close_to_max(got, want, rel=1e-4):
    """float32: within ``rel`` of the largest |want|; bf16: one bf16 ulp per
    element (floor 1e-3 of the largest), as ``_attn_close``."""
    if want.dtype == torch.bfloat16:
        return _attn_close(got, want)
    err = (got.float() - want.float()).abs().max()
    return bool(err <= rel * want.float().abs().max())


def _scan_inputs(B, S, di, n, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)   # noqa: E731
    u = 0.5 * r(B, S, di)
    dt = 0.1 * torch.nn.functional.softplus(r(B, S, di))
    Bm, Cm = r(B, S, n), r(B, S, n)
    A = -torch.exp(0.2 * r(di, n))
    D = torch.ones(di)
    return ([t.to(dev, dtype) for t in (u, dt, Bm, Cm)] + [A.to(dev), D.to(dev)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,n", [
    (1, 64, 8192, 16), (1, 256, 8192, 16),     # the served shape (falcon-mamba-7b)
    (2, 100, 200, 16),                          # ragged di and S
    (2, 33, 64, 4), (1, 40, 96, 8), (1, 70, 64, 24), (1, 37, 64, 64),   # every n template
])
def test_selective_scan_kernel_matches_plain_version(B, S, di, n, dtype):
    from repro_torch.kernels import selective_scan as ss

    dev = _cuda()
    args = _scan_inputs(B, S, di, n, dtype, dev)
    before = ss.LAUNCHES["selective_scan"]
    got = ss.selective_scan(*args)
    assert ss.LAUNCHES["selective_scan"] == before + 1
    want = ref.ref_selective_scan(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, di)
    assert _close_to_max(got, want)
    # control: the D * u term dropped fails the check
    u, D = args[0], args[5]
    assert not _close_to_max((want.float() - D * u.float()).to(dtype), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,n", [
    (1, 256, 8192, 16),                         # the served shape (falcon-mamba-7b)
    (2, 100, 200, 4), (2, 37, 96, 16), (1, 70, 72, 64),   # ragged S and di
    (1, 50, 72, 96), (2, 33, 64, 128),          # more than 64 states: groups of 64
    (70000, 3, 8, 16),                          # B past 65535
])
def test_selective_scan_final_state_matches_plain_version(B, S, di, n, dtype):
    """y and the final state (``return_state``) against the plain version's;
    the state one step early (the plain scan over S - 1 steps) fails."""
    from repro_torch.kernels import selective_scan as ss

    dev = _cuda()
    args = _scan_inputs(B, S, di, n, dtype, dev, seed=n)
    got, h = ss.selective_scan(*args, return_state=True)
    want, h_want = ref.ref_selective_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert h.dtype == torch.float32 and h.shape == (B, di, n)
    assert _close_to_max(got, want)
    assert _close_to_max(h, h_want, rel=1e-5)
    if S > 1:
        early = ref.ref_selective_scan(*(t[:, :-1] for t in args[:4]), *args[4:],
                                       return_state=True)[1]
        assert not _close_to_max(early, h_want, rel=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_lane_variants_match_plain_version(lanes, dtype):
    """Each n = 16 variant (2, 4 or 8 lanes per channel) at a ragged shape."""
    from repro_torch.kernels import selective_scan as ss

    dev = _cuda()
    args = _scan_inputs(2, 130, 200, 16, dtype, dev, seed=lanes)
    got, h = ss.selective_scan(*args, return_state=True, _lanes=lanes)
    want, h_want = ref.ref_selective_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert _close_to_max(got, want) and _close_to_max(h, h_want, rel=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("R,D,dtype", [
    (1024, 4096, torch.bfloat16), (1000, 5120, torch.float32),
    (3, 8192, torch.float32), (5, 1, torch.bfloat16), (7, 333, torch.float32),
    (7, 333, torch.bfloat16), (9, 1004, torch.bfloat16),   # D not a multiple of 8
    (8192, 128, torch.bfloat16),           # many rows: several rows per block step
    (4, 8193, torch.bfloat16), (3, 12288, torch.float32), (2, 16384, torch.bfloat16),
    (5, 8193, torch.float32),              # wider than 8192: the second shape
])
def test_rmsnorm_kernel_matches_plain_version(R, D, dtype):
    from repro_torch.kernels import rmsnorm as rn

    dev = _cuda()
    g = torch.Generator().manual_seed(R + D)
    x = torch.randn(R, D, generator=g).to(dev, dtype)
    scale = (0.1 * torch.randn(D, generator=g)).to(dev)
    before = rn.LAUNCHES["rmsnorm"]
    got = rn.rmsnorm(x, scale, 1e-6)
    assert rn.LAUNCHES["rmsnorm"] == before + 1
    want = ref.ref_rmsnorm(x, scale, 1e-6)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert _close_to_max(got, want)
    if D > 1:   # control: no (1 + scale) fails the check (one value may be ~0)
        assert not _close_to_max(ref.ref_rmsnorm(x, torch.zeros_like(scale)), want)


def _caches_agree(fast, plain, layers, rel):
    """The decode caches of two prefills: ``ssm`` and ``conv`` of the same
    shapes and dtypes, and over ``layers`` within ``rel`` of each one's
    largest value on the plain path."""
    for name in ("ssm", "conv"):
        got, want = fast[name][layers].float(), plain[name][layers].float()
        assert fast[name].shape == plain[name].shape and fast[name].dtype == plain[name].dtype
        assert float((got - want).abs().max()) <= rel * float(want.abs().max()), name


@pytest.mark.gpu
def test_ssm_prefill_through_the_kernel_matches_plain_path():
    """falcon-mamba-7b.reduced() in bf16, prefilled on the card through the
    scan kernel (use_pallas) and through the plain scan: one launch per
    layer, logits within 2% of their largest, the decode caches (the
    kernel's final state and conv rows against the plain tail-state scan's),
    and served tokens through the engine's exact-length prefills."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, ServeConfig

    dev = _cuda()
    cfg = get_config("falcon-mamba-7b").reduced().with_(dtype="bfloat16")
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=torch.Generator().manual_seed(1))
    toks, last = toks.to(dev), torch.tensor([127], device=dev)
    ops.reset_launch_counts()
    fast, fast_caches = T.prefill_at(cfg.with_(use_pallas=True), params, {"tokens": toks}, last)
    assert ops.launch_counts()["selective_scan"] == cfg.n_layers
    plain, plain_caches = T.prefill_at(cfg, params, {"tokens": toks}, last)
    assert ops.launch_counts()["selective_scan"] == cfg.n_layers
    torch.cuda.synchronize()
    err = float((fast.float() - plain.float()).abs().max())
    assert err <= 0.02 * float(plain.float().abs().max()), err
    # layer 0 reads the same input on both paths: the conv rows are equal, the
    # states within 1e-5 of max|h| (sequential and associative orders round
    # apart by a few float32 ulp); later layers read inputs that already part
    # by bf16 roundings, so they get the logits' 2%
    assert torch.equal(fast_caches["conv"][0], plain_caches["conv"][0])
    _caches_agree(fast_caches, plain_caches, slice(0, 1), rel=1e-5)
    _caches_agree(fast_caches, plain_caches, slice(None), rel=0.02)
    ops.reset_launch_counts()
    eng = Engine(cfg.with_(use_pallas=True), params, ServeConfig(max_seq=140, slots=2))
    outs = eng.generate([toks[0].tolist(), [1, 2, 3], toks[0, :64].tolist()], max_new=4)
    assert ops.launch_counts()["selective_scan"] == 2 * cfg.n_layers
    assert eng.scheduler.prefill_buckets() == (3, 64, 128)
    assert all(len(o) == n + 4 for o, n in zip(outs, (128, 3, 64)))


@pytest.mark.gpu
def test_ssm_prefill_caches_through_the_kernel_match_plain_path_float32():
    """falcon-mamba-7b.reduced() in float32: every layer's decode caches
    through the scan kernel against the plain tail-state scan's, the states
    within 1e-5 of max|h| and the conv rows within 1e-5 of their largest
    (layers past the first read inputs that part by the y sums' order,
    ~1e-7 relative)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    dev = _cuda()
    cfg = get_config("falcon-mamba-7b").reduced().with_(dtype="float32")
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 192), generator=torch.Generator().manual_seed(2))
    toks, last = toks.to(dev), torch.tensor([191, 191], device=dev)
    _, fast = T.prefill_at(cfg.with_(use_pallas=True), params, {"tokens": toks}, last)
    _, plain = T.prefill_at(cfg, params, {"tokens": toks}, last)
    torch.cuda.synchronize()
    assert torch.equal(fast["conv"][0], plain["conv"][0])
    _caches_agree(fast, plain, slice(None), rel=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_forward_on_card_matches_cpu(arch):
    """``moe_forward`` of the reduced config in float32 on the card against
    the same call on the CPU: equal expert ids and kept routes (capacity
    factor 0.5, so routes drop), y within rtol 1e-5 / atol 1e-5 and aux
    within rtol 1e-6 (the products sum in other orders)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    dev = _cuda()
    cfg = get_config(arch).reduced().with_(capacity_factor=0.5)
    p = M.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 96, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pd = {k: v.to(dev) for k, v in p.items()}
    routes = []
    for xx, pp in ((x, p), (x.to(dev), pd)):
        _, ids, _ = M.route(cfg, pp, xx.reshape(-1, cfg.d_model))
        keep = M.dispatch(ids, cfg.n_experts, M.moe_capacity(cfg, 192))[2]
        routes.append((ids.cpu(), keep.cpu()))
    assert torch.equal(routes[0][0], routes[1][0]) and torch.equal(routes[0][1], routes[1][1])
    assert not bool(routes[0][1].all())
    y, aux = M.moe_forward(cfg, p, x)
    yd, auxd = M.moe_forward(cfg, pd, x.to(dev))
    torch.testing.assert_close(yd.cpu(), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(auxd.cpu(), aux, rtol=1e-6, atol=0.0)


@pytest.mark.gpu
def test_hybrid_prefill_caches_through_the_kernel_match_plain_path():
    """hymba-1.5b.reduced() at 4 layers in float32, a 192-token exact-length
    prefill on the card through the scan kernel (one launch per layer; the
    attention stays plain, its windows differing by layer) and through the
    plain path: logits within 1e-4 of their largest, k and v within 1e-5 of
    their largest, the conv rows and the ssm states as falcon-mamba's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    dev = _cuda()
    cfg = get_config("hymba-1.5b").reduced().with_(n_layers=4, dtype="float32")
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 192), generator=torch.Generator().manual_seed(2))
    toks, last = toks.to(dev), torch.tensor([191, 191], device=dev)
    ops.reset_launch_counts()
    fast_logits, fast = T.prefill_at(cfg.with_(use_pallas=True), params, {"tokens": toks}, last)
    counts = ops.launch_counts()
    assert counts["selective_scan"] == cfg.n_layers and counts["flash_attention"] == 0
    plain_logits, plain = T.prefill_at(cfg, params, {"tokens": toks}, last)
    torch.cuda.synchronize()
    assert sorted(fast) == sorted(plain) == ["conv", "k", "ssm", "v"]
    err = float((fast_logits - plain_logits).abs().max())
    assert err <= 1e-4 * float(plain_logits.abs().max()), err
    assert torch.equal(fast["conv"][0], plain["conv"][0])
    _caches_agree(fast, plain, slice(None), rel=1e-5)
    for name in ("k", "v"):
        assert torch.equal(fast[name][0], plain[name][0])
        err = float((fast[name] - plain[name]).abs().max())
        assert err <= 1e-5 * float(plain[name].abs().max()), name


# the manifest of _ckpt_tree's checkpoint at step 3, as msgpack.packb writes it
GOLDEN_MANIFEST = bytes.fromhex(
    "84a47374657003a56e616d657395a85b2761275d5b305da85b2761275d5b315da55b2762275da55b2763"
    "275da55b276e275da664747970657395a7666c6f61743332a5696e743332a862666c6f61743136a569"
    "6e743634a5696e743634a67368617065739591cd012c92020392ce0001117002910190")


def _ckpt_tree(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    return {"a": [torch.randn(300, generator=g, device=dev),
                  torch.arange(-3, 3, dtype=torch.int32, device=dev).reshape(2, 3)],
            "b": torch.randn(70000, 2, generator=g, device=dev).to(torch.bfloat16),
            "c": torch.tensor([2 ** 40 + 1], dtype=torch.int64, device=dev),
            "n": 7}


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(tmp_path):
    """``checkpoint.save`` of card tensors (float32, int32, bfloat16, int64
    and a Python int) and ``restore(device="cuda")``: every leaf bit for bit
    with its dtype, on the card; the manifest is the bytes msgpack writes
    (packed and read by ``checkpoint.manifest``, no msgpack here)."""
    from repro_torch.checkpoint import manifest, restore, save
    from repro_torch.tree import tree_leaves

    dev = _cuda()
    tree = _ckpt_tree(dev)
    path = save(str(tmp_path), 3, tree)
    with open(f"{path}/manifest.msgpack", "rb") as f:
        raw = f.read()
    assert raw == GOLDEN_MANIFEST
    assert manifest.pack(manifest.unpack(raw)) == raw
    got, step = restore(str(tmp_path), tree, device=dev)
    assert step == 3
    want = [torch.as_tensor(x, device=dev) for x in tree_leaves(tree)]
    for a, b in zip(tree_leaves(got), want):
        assert a.device == b.device and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flat_kernels_past_2_31_elements():
    """zo_perturb_flat and zo_reconstruct_flat on a packed buffer of
    2^31 + 2^20 + 3 * 4096 floats (three leaves, the middle one crossing
    element 2^31; 8.6 GB each for x and the output): the blocks around
    element 2^31 and the last 64 blocks against the plain version on the
    same rows (perturb rtol 1e-5 / atol 1e-6, reconstruct bit for bit)."""
    dev = _cuda()
    block = 4096
    sizes = [5000, (1 << 31) + (1 << 20) - 9000, 4097]
    salts1, ctrs, nvalid = (to_t(a).to(dev) for a in flat_meta(sizes, block))
    nb = int(ctrs.shape[0])
    assert nb * block > 1 << 31
    b31 = (1 << 31) // block
    idx = torch.tensor(sorted({*range(b31 - 2, b31 + 3), *range(nb - 64, nb)}), device=dev)
    rows = lambda t: t.view(torch.int32)[idx].contiguous().view(torch.uint32)  # noqa: E731
    x = torch.randn(nb * block, device=dev)
    out = cu.zo_perturb_flat(x, salts1, ctrs, nvalid, 0.01, block)
    xs = x.view(nb, block)[idx].reshape(-1)
    want = ref.ref_zo_perturb_flat(xs, rows(salts1), rows(ctrs), nvalid[idx].contiguous(),
                                   0.01, block)
    torch.testing.assert_close(out.view(nb, block)[idx].reshape(-1), want, **FP32_TOL)
    del out, x
    msalts = to_t(multi_salts(salts1.cpu().numpy(), 2, 613)).to(dev)
    coeffs = torch.tensor([0.5, -1.5], device=dev)
    got = cu.zo_reconstruct_flat(msalts, coeffs, ctrs, nvalid, block)
    want = ref.ref_zo_reconstruct_flat(rows(msalts), coeffs, rows(ctrs),
                                       nvalid[idx].contiguous(), block)
    assert torch.equal(got.view(nb, block)[idx].reshape(-1), want)
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# the simulator and the traffic replay on the card
# --------------------------------------------------------------------------- #
SIM_SCENARIOS = {
    "sync": {},
    "elastic": dict(elastic=True, fail_rate=300.0, downtime=2e-3, restart_time=1e-5,
                    jitter_sigma=0.1, seed=3),
    "stale2": dict(rel_speeds=(1.0, 1.0, 1.0, 0.25), max_staleness=2),
    "federated": dict(n_clients=64, cohort_k=4, availability=0.75, seed=9),
}


@pytest.mark.gpu
@pytest.mark.parametrize("scenario,which", [
    ("sync", "ho_sgd"), ("sync", "zo_sgd"), ("elastic", "ho_sgd"), ("stale2", "ho_sgd"),
    ("federated", "fed_ho_sgd")])
def test_sim_flat_matches_tree_on_card(scenario, which):
    """``simulate`` at hidden 16 on the card, engine flat (the kernels)
    against tree (plain PyTorch): the trace, orders, bytes, membership,
    failures and rejoins equal, losses to rtol 1e-4, the final parameters
    within 2% of the update; the flat run launches its kernels (the fused
    pair on full synchronous rounds, the generic pair on the executor's)."""
    from repro_torch.data.synthetic import batches, make_classification
    from repro_torch.kernels import ops
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss
    from repro_torch.sim import ClusterSpec, compute_model_for, make_sim_methods, simulate

    dev = _cuda()
    ds = make_classification("covtype", n_train=1024, n_test=256, seed=0)
    p0 = init_mlp_classifier(torch.Generator().manual_seed(0), ds.n_features, ds.n_classes,
                             hidden=16, device=dev)
    spec = ClusterSpec(m=4, flops_per_sec=1e9, alpha=1e-5, bandwidth=1e6,
                       **{"seed": 0, **SIM_SCENARIOS[scenario]})
    runs = {}
    for engine in ("tree", "flat"):
        sm = make_sim_methods(mlp_loss, p0, spec, tau=4, lr=0.05, engine=engine,
                              which=[which], local_steps=2)[which]
        ops.reset_launch_counts()
        res = simulate(sm, p0, batches(ds, 32, seed=1), spec, 16,
                       compute=compute_model_for(p0, spec, 8))
        runs[engine] = (res, ops.launch_counts())
    (tree, tree_n), (flat, flat_n) = runs["tree"], runs["flat"]
    assert flat.trace == tree.trace and flat.orders == tree.orders
    assert flat.comm_bytes == tree.comm_bytes and flat.active_counts == tree.active_counts
    assert (flat.failures, flat.rejoins) == (tree.failures, tree.rejoins)
    np.testing.assert_allclose(flat.losses, tree.losses, rtol=1e-4)
    for k, p in p0.items():
        scale = float((tree.params[k] - p).abs().max())
        assert float((flat.params[k] - tree.params[k]).abs().max()) <= 0.02 * scale + 1e-7, k
    assert not any(tree_n.values())
    fused = flat_n["zo_perturb_sumsq"] + flat_n["zo_reconstruct_update"]
    generic = flat_n["zo_perturb_flat"] + flat_n["zo_reconstruct_flat"]
    if scenario == "sync":
        assert fused > 0 and generic == 0, flat_n
    else:      # shrunk membership, stale views and cohorts run the executor
        assert generic > 0, flat_n
    if scenario == "federated":
        assert fused == 0, flat_n


@pytest.mark.gpu
def test_traffic_cli_on_card_matches_cpu_prices(tmp_path, capsys):
    """``launch.serve.main --traffic`` at qwen3-14b smoke size on the card:
    the mixed mix's 48-token prompts prefill through the flash kernel, and
    with EOS off the per-request rows equal the CPU run's (the prices do not
    depend on the tokens)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    _cuda()
    argv = ["--arch", "qwen3-14b", "--reduce", "smoke", "--traffic", "poisson:50.0,mixed",
            "--requests", "8", "--slots", "4"]
    ops.reset_launch_counts()
    serve.main(argv + ["--log", str(tmp_path / "card.csv")])
    card = capsys.readouterr().out
    assert ops.launch_counts()["flash_attention"] > 0
    serve.main(argv + ["--device", "cpu", "--log", str(tmp_path / "cpu.csv")])
    cpu = capsys.readouterr().out
    assert (tmp_path / "card.csv").read_text() == (tmp_path / "cpu.csv").read_text()
    assert card.splitlines()[1:] == cpu.splitlines()[1:]
    assert "traffic poisson:50.0,mixed: 8 requests" in card
