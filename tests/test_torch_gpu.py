"""The port's CUDA kernels on the card (skipped without a CUDA device).

Run on a GPU machine from the repository root with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX (the GPU machine has none): each kernel is held
against its plain PyTorch version on the same inputs, fp32 outputs to
rtol 1e-5 / atol 1e-6 (the two differ at most by ulps of logf/cosf and by
the order of the sum of squares) and bf16-rounded outputs to one bf16 ulp
per element with at most 0.1% of the elements differing at all; an fp32
accumulator fails that check.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import zo_direction as cu
from torch_flat_helpers import bf16_match, flat_meta, multi_salts, packed, to_t

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
