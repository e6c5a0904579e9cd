"""The port's CUDA kernels on the card (skipped without a CUDA device).

Run on a GPU machine from the repository root with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX (the GPU machine has none): each kernel is held
against its plain PyTorch version on the same inputs.  Per-leaf kernels: fp32
outputs bitwise, bf16 ones to one bf16 ulp, the sum of squares to rtol
1e-6.  Flat kernels: fp32 outputs to
rtol 1e-5 / atol 1e-6 (the two differ at most by ulps of logf/cosf and by
the order of the sum of squares) and bf16-rounded outputs to one bf16 ulp
per element with at most 0.1% of the elements differing at all; an fp32
accumulator fails that check.  Flash attention is held to its plain version
in float32 to rtol 1e-5 / atol 1e-5 and in bf16 to one bf16 ulp per element
(values under 1e-3 of the largest count as 1e-3 of it): both compute in
float32 in other summation orders and round once.
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
    if acc_dtype == "float32":
        torch.testing.assert_close(got, want, **FP32_TOL)
    else:
        assert bf16_match(got, want)
        # control: the fp32 accumulator's output fails the bf16 check
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
    (128, 4, 4, 96, True, None, None),     # phi3's head width
    (64, 4, 1, 64, False, None, None),
    (128, 4, 2, 32, True, 8, None),        # reduced() configs
])
def test_flash_attention_kernel_matches_plain_version(S, H, KV, hd, causal, window,
                                                       softcap, dtype):
    from repro_torch.kernels import flash_attention as fa

    dev = _cuda()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, S, n, hd, generator=g).to(dev, dtype) for n in (H, KV, KV))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal, window, softcap)
    assert fa.LAUNCHES["flash_attention"] == before + 1
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
