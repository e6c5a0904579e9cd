"""The port's kernel plain versions against the JAX kernels, on the CPU.

``repro_torch.kernels.ops`` on a CPU tensor runs the plain PyTorch version;
``repro.kernels.ops`` runs the Pallas kernel in interpret mode.  Both get the
same inputs, made with numpy.  Sweeps follow tests/test_kernels.py: uneven
tail blocks, scalar-sized leaves, the bf16 mask, a bf16 accumulator and
momentum 0 / 0.9, m in {1, 3, 4, 8} and a block of 257, so that a CUDA
kernel's 16-byte vectors would cross blocks' edges.  Tolerances: sum of
squares rtol 1e-5; other outputs
rtol 1e-5 / atol 1e-6 (Gaussians differ by ulps between the two math
libraries), loosened only where a bf16 rounding can flip on such an ulp.
Inside PyTorch, the fused commit is pinned bitwise to the unfused
``apply_deltas . sgd.update . zo_reconstruct_flat`` composition.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import zo_direction as cu
from torch_flat_helpers import flat_meta, multi_salts, packed, to_t

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

FLAT_LAYOUTS = [
    ([1000, 261], 256),   # tail blocks on both leaves
    ([37, 3, 1], 8),      # tiny leaves incl. a scalar-sized one
    ([129], 64),          # single leaf, odd tail
    ([771, 514, 1, 5], 257),   # whole blocks, leaf edges off a multiple of 4
]
BF16_TOL = dict(rtol=1e-2, atol=1e-2)   # one bf16 ulp of the values here


@pytest.mark.parametrize("sizes,block", FLAT_LAYOUTS)
def test_zo_perturb_flat_matches_jax(sizes, block):
    salts, ctrs, nvalid = flat_meta(sizes, block)
    x = packed(sizes, block)
    want = jops.zo_perturb_flat(jnp.asarray(x), jnp.asarray(salts), jnp.asarray(ctrs),
                                jnp.asarray(nvalid), jnp.float32(3e-3), block=block)
    got = ops.zo_perturb_flat(to_t(x), to_t(salts), to_t(ctrs), to_t(nvalid), 3e-3, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # padding lanes pass through unchanged (zeros stay zeros)
    valid = (np.arange(block)[None, :] < nvalid[:, None]).reshape(-1)
    assert np.all(got.numpy()[~valid] == x[~valid])


@pytest.mark.parametrize("sizes,block", FLAT_LAYOUTS)
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_zo_reconstruct_flat_matches_jax(sizes, block, acc_dtype):
    m = 4
    salts1, ctrs, nvalid = flat_meta(sizes, block)
    msalts = multi_salts(salts1, m, 1009)
    coeffs = np.asarray([0.5, -1.0, 2.0, 0.1], np.float32)
    want = jops.zo_reconstruct_flat(jnp.asarray(msalts), jnp.asarray(coeffs),
                                    jnp.asarray(ctrs), jnp.asarray(nvalid),
                                    block=block, acc_dtype=acc_dtype)
    got = ops.zo_reconstruct_flat(to_t(msalts), to_t(coeffs), to_t(ctrs), to_t(nvalid),
                                  block, acc_dtype)
    tol = dict(rtol=1e-5, atol=1e-6) if acc_dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    valid = (np.arange(block)[None, :] < nvalid[:, None]).reshape(-1)
    assert np.all(got.numpy()[~valid] == 0.0)


@pytest.mark.parametrize("sizes,block", FLAT_LAYOUTS)
def test_zo_perturb_sumsq_matches_jax(sizes, block):
    salts, ctrs, nvalid = flat_meta(sizes, block)
    x = packed(sizes, block)
    want, wss = jops.zo_perturb_sumsq(jnp.asarray(x), jnp.asarray(salts),
                                      jnp.asarray(ctrs), jnp.asarray(nvalid),
                                      1e-3, block=block)
    got, ss = ops.zo_perturb_sumsq(to_t(x), to_t(salts), to_t(ctrs), to_t(nvalid), 1e-3, block)
    assert ss.shape == (1,)
    np.testing.assert_allclose(float(ss[0]), float(np.asarray(wss).reshape(())),
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # and it is the oracle's blockwise sum of squares of the valid lanes
    g, valid = ref._flat_gauss(to_t(salts), to_t(ctrs), to_t(nvalid), block)
    np.testing.assert_allclose(float(ss[0]), float(torch.sum(g[valid] ** 2)), rtol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_zo_reconstruct_update_matches_jax(momentum, acc_dtype):
    """The fused commit, incl. the bf16-leaf rounding path (the second
    leaf's two blocks are flagged bf16)."""
    _update_matches_jax([1000, 261], 256, 4, momentum, acc_dtype)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("sizes,block", [([1000, 261], 256), ([771, 514], 257)])
def test_zo_reconstruct_update_matches_jax_at_m_and_block(sizes, block, m, acc_dtype, momentum):
    """The same at one, three and eight workers, and at a block of 257."""
    _update_matches_jax(sizes, block, m, momentum, acc_dtype)


def _update_matches_jax(sizes, block, m, momentum, acc_dtype):
    salts1, ctrs, nvalid = flat_meta(sizes, block)
    msalts = multi_salts(salts1, m, 613)
    nb0 = -(-sizes[0] // block)                   # the fp32 leaf's blocks
    bf16 = np.asarray([0] * nb0 + [1] * (len(salts1) - nb0), np.int32)
    coeffs = np.asarray([0.25, -0.75, 1.5, 0.3, -1.1, 0.6, 2.2, -0.4][:m], np.float32)
    p = packed(sizes, block)
    mom = None if momentum == 0.0 else np.full_like(p, 0.1)
    lr = 0.05
    want_p, want_m = jops.zo_reconstruct_update(
        jnp.asarray(p), None if mom is None else jnp.asarray(mom), jnp.asarray(msalts),
        jnp.asarray(ctrs), jnp.asarray(nvalid), jnp.asarray(bf16), jnp.asarray(coeffs),
        lr, momentum=momentum, block=block, acc_dtype=acc_dtype)
    tp, tm = to_t(p), None if mom is None else to_t(mom)
    got_p, got_m = ops.zo_reconstruct_update(
        tp, tm, to_t(msalts), to_t(ctrs), to_t(nvalid), to_t(bf16), to_t(coeffs), lr,
        momentum, block, acc_dtype)
    assert got_p is tp and got_m is tm            # in place, like the aliases
    fp32 = acc_dtype == "float32"
    n0 = nb0 * block
    np.testing.assert_allclose(got_p.numpy()[:n0], np.asarray(want_p)[:n0],
                               **(dict(rtol=1e-5, atol=1e-6) if fp32 else BF16_TOL))
    np.testing.assert_allclose(got_p.numpy()[n0:], np.asarray(want_p)[n0:], **BF16_TOL)
    if momentum:
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                                   **(dict(rtol=1e-5, atol=1e-6) if fp32 else BF16_TOL))
    else:
        assert got_m is None and want_m is None


@pytest.mark.parametrize("n,offset", [(4096, 0), (5000, 77), (37, 3), (1, 0)])
def test_per_leaf_oracles_match_jax(n, offset):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    np.testing.assert_allclose(
        ref.ref_zo_perturb(to_t(x), 55, 0.01, offset).numpy(),
        np.asarray(jref.ref_zo_perturb(jnp.asarray(x), 55, 0.01, offset)),
        rtol=1e-5, atol=1e-6)
    salts = np.asarray([1, 2, 3, 0xFFFFFFFF], np.uint32)
    coeffs = np.asarray([0.5, -1.0, 2.0, 0.1], np.float32)
    for acc in ("float32", "bfloat16"):
        got = ref.ref_zo_reconstruct(n, salts, coeffs, offset, acc_dtype=acc)
        want = jref.ref_zo_reconstruct(n, jnp.asarray(salts), jnp.asarray(coeffs),
                                       offset, acc_dtype=jnp.dtype(acc))
        tol = dict(rtol=1e-5, atol=1e-6) if acc == "float32" else BF16_TOL
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    g = ref._ref_flat_gauss(9, offset, min(n, 5), 8)
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jref._ref_flat_gauss(9, offset, min(n, 5), 8)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_fused_commit_bitwise_equals_unfused_composition(m, acc_dtype):
    """Inside PyTorch the fused commit equals ``apply_deltas . sgd.update .
    zo_reconstruct_flat`` bit for bit, across momentum steps, m,
    accumulator dtypes and uneven tail blocks (cf. test_kernels.py:295)."""
    from repro_torch.opt.optimizers import apply_deltas, const_schedule, sgd

    sizes, block = [1000, 261], 256
    salts1, ctrs, nvalid = flat_meta(sizes, block)
    msalts = to_t(multi_salts(salts1, m, 271))
    ctrs, nvalid = to_t(ctrs), to_t(nvalid)
    bf16 = torch.zeros(len(salts1), dtype=torch.int32)
    lr, momentum = 0.05, 0.9
    opt = sgd(const_schedule(lr), momentum)

    p_ref = to_t(packed(sizes, block))
    state = opt.init(p_ref)
    p_k, mom_k = p_ref.clone(), torch.zeros_like(p_ref)
    for t in range(3):
        coeffs = torch.linspace(-1.0, 1.0, m + 1)[1:] * float(t + 1)
        g = ops.zo_reconstruct_flat(msalts, coeffs, ctrs, nvalid, block, acc_dtype)
        deltas, state = opt.update(g, state, p_ref, t)
        p_ref = apply_deltas(p_ref, deltas)
        ops.zo_reconstruct_update(p_k, mom_k, msalts, ctrs, nvalid, bf16, coeffs,
                                  lr, momentum, block, acc_dtype)
    assert torch.equal(p_k, p_ref)
    assert torch.equal(mom_k, state)


def test_cpu_path_launches_no_kernel_and_checks_devices():
    """On CPU tensors the wrappers run the plain versions (no launch is
    counted); the CUDA entry points refuse CPU tensors instead of falling back."""
    salts, ctrs, nvalid = (to_t(a) for a in flat_meta([100], 64))
    x = torch.zeros(128)
    ops.reset_launch_counts()
    ops.zo_perturb_flat(x, salts, ctrs, nvalid, 1.0, 64)
    ops.zo_perturb_sumsq(x, salts, ctrs, nvalid, 1.0, 64)
    assert sum(ops.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        cu.zo_perturb_flat(x, salts, ctrs, nvalid, 1.0, 64)
    with pytest.raises(ValueError, match="not 2 blocks"):
        ops.zo_perturb_flat(torch.zeros(100), salts, ctrs, nvalid, 1.0, 64)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 1, 3])
def test_outputs_take_the_input_alignment(dtype, shift):
    """The buffers the CUDA wrappers allocate for zo_perturb and
    zo_perturb_sumsq (output, scratch) start at x's address mod 16 bytes,
    so a view off a 16-byte boundary still takes 16-byte accesses; every
    function counted in LAUNCHES says how many launches a call makes."""
    x = torch.zeros(64, dtype=dtype)[shift:shift + 40]
    out = cu._aligned_like(x)
    assert out.data_ptr() % 16 == x.data_ptr() % 16
    assert out.shape == x.shape and out.dtype == dtype and out.is_contiguous()
    assert set(cu.LAUNCHES_PER_CALL) == set(cu.LAUNCHES)
    assert cu.LAUNCHES_PER_CALL["zo_perturb_sumsq"] == 2


def test_lr_and_mu_go_to_the_kernels_by_value():
    """The CUDA wrappers pass zo_reconstruct_update's lr and
    zo_perturb_sumsq's mu by value: a Python number and a CPU tensor give
    the same float32 (a schedule's value is a CPU float32 tensor), a float64
    tensor is rounded like a number, and a tensor on another device raises
    TypeError rather than syncing the host with it."""
    want = float(np.float32(0.05))
    assert cu._host_f32(0.05, "lr") == want
    assert cu._host_f32(torch.tensor(0.05, dtype=torch.float32), "lr") == want
    assert cu._host_f32(torch.tensor([0.05], dtype=torch.float64), "lr") == want
    assert cu._host_f32(np.float32(0.05), "lr") == want
    assert cu._host_f32(3, "mu") == 3.0
    with pytest.raises(TypeError, match="lr: taken by value"):
        cu._host_f32(torch.tensor(0.05, device="meta"), "lr")
