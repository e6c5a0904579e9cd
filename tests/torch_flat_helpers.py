"""Inputs and checks shared by the port's ZO-kernel tests (no JAX here:
``tests/test_torch_gpu.py`` runs on a GPU machine without it)."""
import numpy as np
import torch


def flat_meta(sizes, block, base_salt=100):
    """Per-block (salt, counter start, valid lanes) of leaves of ``sizes``."""
    salts, ctrs, nvalid = [], [], []
    for li, n in enumerate(sizes):
        for b in range(max(1, -(-n // block))):
            salts.append(base_salt + li)
            ctrs.append(b * block)
            nvalid.append(min(block, n - b * block))
    return (np.asarray(salts, np.uint32), np.asarray(ctrs, np.uint32),
            np.asarray(nvalid, np.int32))


def packed(sizes, block, seed=0):
    """Normal values for each leaf, each padded with zeros to whole blocks."""
    rng = np.random.default_rng(seed)
    parts = []
    for n in sizes:
        nb = max(1, -(-n // block))
        parts.append(np.pad(rng.normal(size=n).astype(np.float32), (0, nb * block - n)))
    return np.concatenate(parts)


def leaf(n, seed=0):
    """One leaf of ``n`` normal float32 values."""
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def to_t(a):
    return torch.from_numpy(np.array(a))


def multi_salts(salts1, m, stride):
    return np.stack([salts1 + np.uint32(w * stride) for w in range(m)], axis=1)


def bf16_match(got, want, max_frac=1e-3):
    """Whether a bf16-rounded output matches: every element within one bf16
    ulp of its own value and at most ``max_frac`` of them not bitwise equal
    (an ulp of log/cos may flip a rounding; a skipped rounding flips many)."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(want)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), e - 8))
    frac = float((got != want).float().mean())
    return bool(((got - want).abs() <= ulp).all()) and frac <= max_frac
