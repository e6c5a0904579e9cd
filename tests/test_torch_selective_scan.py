"""The selective scan and RMSNorm of the port against the JAX package, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.selective_scan`` and ``.rmsnorm``
run their kernels' plain versions (``kernels.ref``); the reference runs its
Pallas kernels in interpret mode.  The same numpy inputs go through both,
over the reference's own sweeps (``tests/test_kernels.py``) and tolerances:
the scan to rtol/atol 1e-4 in float32 and 2e-2 in bf16, RMSNorm to 2e-4 in
float32 and 2e-2 in bf16.  The plain scan's final state (``return_state``,
what the CUDA kernel also writes) is held against the last step of the
reference model's associative scan (``repro.models.ssm._assoc_scan``) within
1e-5 of max|h|: the sequential and the associative orders round differently,
by a few float32 ulp.  The kernels' input checks run here too; the CUDA
kernels themselves are held against the same plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss

torch.set_num_threads(1)


def _tol(bf16):
    return dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-4, atol=2e-4)


def _pair(a, bf16):
    """(jax array, torch tensor) of one float32 numpy array, both rounded to
    bf16 when asked (the same bits on both sides)."""
    j = jnp.asarray(a)
    if bf16:
        j = j.astype(jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)
    return j, torch.from_numpy(a)


def scan_inputs(S, di, n, B=2, seed=0):
    """The reference test's distributions: u ~ 0.5 N, dt = 0.1 softplus(N),
    B and C ~ N, A = -exp(0.2 N), D = 1."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    u = 0.5 * f(B, S, di)
    dt = (0.1 * np.logaddexp(f(B, S, di), 0)).astype(np.float32)
    return u, dt, f(B, S, n), f(B, S, n), -np.exp(0.2 * f(di, n)), np.ones(di, np.float32)


@pytest.mark.parametrize("S,di,n,bd,bs", [
    (64, 64, 16, 32, 32), (128, 128, 8, 128, 64), (96, 32, 4, 16, 32),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_selective_scan_matches_pallas_kernel(S, di, n, bd, bs, bf16):
    u, dt, Bm, Cm, A, D = scan_inputs(S, di, n)
    j = [_pair(a, bf16) for a in (u, dt, Bm, Cm)]
    want = jops.selective_scan(*(x for x, _ in j), jnp.asarray(A), jnp.asarray(D),
                               block_d=bd, block_s=bs)
    got = ops.selective_scan(*(t for _, t in j), torch.from_numpy(A), torch.from_numpy(D))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tuple(got.shape) == (2, S, di)
    tol = _tol(bf16) if bf16 else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S", [1, 7, 64])
def test_ref_selective_scan_matches_jax_ref(S):
    """The plain version against the reference's sequential oracle, and
    against the recurrence written out in numpy float64 (h from 0, y_t =
    h_t . C_t + D u_t)."""
    u, dt, Bm, Cm, A, D = scan_inputs(S, 24, 5, seed=S)
    got = ref.ref_selective_scan(*(torch.from_numpy(a) for a in (u, dt, Bm, Cm, A, D)))
    want = jref.ref_selective_scan(*(jnp.asarray(a) for a in (u, dt, Bm, Cm, A, D)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    h = np.zeros((2, 24, 5))
    y = np.zeros((2, S, 24))
    for t in range(S):
        h = np.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None]
        y[:, t] = (h * Cm[:, t, None]).sum(-1) + D * u[:, t]
    np.testing.assert_allclose(got.numpy(), y, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S,n", [(1, 5), (7, 16), (64, 16), (33, 3)])
def test_ref_selective_scan_final_state_matches_jax_assoc_scan(S, n):
    """``return_state`` gives the plain scan's last h, the state the reference
    model keeps for decode: the last step of its associative scan over
    ``exp(dt A)`` and ``(dt u) B``, from the same numpy inputs.  The output
    itself does not change."""
    u, dt, Bm, Cm, A, D = scan_inputs(S, 24, n, seed=10 + S)
    args = [torch.from_numpy(a) for a in (u, dt, Bm, Cm, A, D)]
    y, h = ref.ref_selective_scan(*args, return_state=True)
    assert torch.equal(y, ref.ref_selective_scan(*args))
    assert h.dtype == torch.float32 and tuple(h.shape) == (2, 24, n)
    dA = jnp.exp(jnp.asarray(dt)[..., None] * jnp.asarray(A))
    dBu = (jnp.asarray(dt) * jnp.asarray(u))[..., None] * jnp.asarray(Bm)[:, :, None, :]
    want = np.asarray(JS._assoc_scan(dA, dBu)[:, -1])
    np.testing.assert_allclose(h.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bf16", [False, True])
def test_ops_selective_scan_returns_the_state_on_cpu(bf16):
    """``ops.selective_scan(..., return_state=True)`` on CPU tensors: the
    plain version's y (in u's dtype) and its float32 final state."""
    u, dt, Bm, Cm, A, D = scan_inputs(16, 8, 4, seed=3)
    dtype = torch.bfloat16 if bf16 else torch.float32
    args = [torch.from_numpy(a).to(dtype) for a in (u, dt, Bm, Cm)]
    args += [torch.from_numpy(A), torch.from_numpy(D)]
    y, h = ops.selective_scan(*args, return_state=True)
    assert y.dtype == dtype and h.dtype == torch.float32 and tuple(h.shape) == (2, 8, 4)
    y2, h2 = ref.ref_selective_scan(*args, return_state=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("rows,d", [(8, 64), (64, 256), (32, 1024), (128, 80)])
@pytest.mark.parametrize("bf16", [False, True])
def test_rmsnorm_matches_pallas_kernel(rows, d, bf16):
    rng = np.random.default_rng(rows + d)
    jx, tx = _pair(rng.standard_normal((rows, d)).astype(np.float32), bf16)
    s = rng.standard_normal(d).astype(np.float32)
    want = jops.rmsnorm(jx, jnp.asarray(s))
    got = ops.rmsnorm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(bf16))


def test_rmsnorm_any_leading_shape():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 5, 48)).astype(np.float32))
    s = torch.linspace(-0.5, 0.5, 48)
    got = ops.rmsnorm(x, s, eps=1e-5)
    want = jops.rmsnorm(jnp.asarray(x.numpy()), jnp.asarray(s.numpy()), eps=1e-5)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_wrappers_on_cpu_count_no_launch():
    ops.reset_launch_counts()
    u, dt, Bm, Cm, A, D = (torch.from_numpy(a) for a in scan_inputs(8, 16, 4))
    ops.selective_scan(u, dt, Bm, Cm, A, D)
    ops.rmsnorm(u, torch.zeros(16))
    counts = ops.launch_counts()
    assert counts["selective_scan"] == 0 and counts["rmsnorm"] == 0


def _bad_scan_args():
    u, dt, Bm, Cm, A, D = (torch.from_numpy(a) for a in scan_inputs(8, 16, 4))
    return [
        ((u[0], dt, Bm, Cm, A, D), ValueError),               # u not 3-d
        ((u.double(), dt, Bm, Cm, A, D), TypeError),          # dtype
        ((u, dt[:, :4], Bm, Cm, A, D), ValueError),           # dt's shape
        ((u, dt, Bm[..., :3], Cm, A, D), ValueError),         # B's n
        ((u, dt, Bm, Cm, A[:8], D), ValueError),              # A's di
        ((u, dt, Bm, Cm, A, D[:3]), ValueError),              # D's shape
        ((u, dt, Bm[..., :0], Cm[..., :0], torch.zeros(16, 0), D), ValueError),  # n = 0
        ((u, dt, Bm, Cm, "A", D), TypeError),
    ]


@pytest.mark.parametrize("case", range(8))
def test_selective_scan_kernel_rejects_what_it_cannot_take(case):
    args, err = _bad_scan_args()[case]
    with pytest.raises(err):
        ss.check_inputs(*args)


@pytest.mark.parametrize("B,S,di,n", [(2, 8, 16, 65), (1, 4, 8, 128), (1, 2, 8, 300),
                                      (70000, 2, 8, 4), (3, 5, 7, 1)])
def test_selective_scan_kernel_takes_any_n_and_b(B, S, di, n):
    """The kernel has no state or batch limit of its own: more than 64
    states go in groups, and B goes on the grid's x axis."""
    f = lambda *s: torch.zeros(*s)   # noqa: E731
    ss.check_inputs(f(B, S, di), f(B, S, di), f(B, S, n), f(B, S, n), f(di, n), f(di))


def test_kernel_wrappers_take_cuda_tensors_only():
    """The CUDA wrappers raise on CPU tensors (``ops`` sends those to the
    plain versions); their input checks pass on what the kernels take."""
    u, dt, Bm, Cm, A, D = (torch.from_numpy(a) for a in scan_inputs(8, 16, 4))
    ss.check_inputs(u, dt, Bm, Cm, A, D)
    with pytest.raises(ValueError, match="CUDA"):
        ss.selective_scan(u, dt, Bm, Cm, A, D)
    rn.check_inputs(u[0], torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(u[0], torch.zeros(16))
    for x, s, err in ((u, torch.zeros(16), ValueError),
                      (u[0].double(), torch.zeros(16), TypeError),
                      (u[0], torch.zeros(15), ValueError)):
        with pytest.raises(err):
            rn.check_inputs(x, s)
    # rows wider than the one-pass shape's MAX_D take the kernel's second shape
    for D in (rn.MAX_D + 1, 12288, 16384):
        rn.check_inputs(torch.zeros(2, D), torch.zeros(D))
