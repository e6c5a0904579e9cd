"""repro_torch.core.directions against repro.core.directions on the CPU.

The integer hash (mix32, fold, the top-24-bit uniforms) must match bit for
bit; Gaussians within rtol=1e-5, atol=1e-6, since log and cos differ by ulps
between XLA's and PyTorch's math libraries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import directions as JD
from repro_torch.core import directions as TD

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

WORDS = np.array([0, 1, 2, 12345, 0x7FFFFFFF, 0x80000000, 0x9E3779B9,
                  0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _t(words):
    return torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64))


def test_mix32_bit_exact_including_extreme_words():
    """0xFFFFFFFF (and the other extremes) through both 32-bit multiplies."""
    rng = np.random.default_rng(0)
    words = np.concatenate([WORDS, rng.integers(0, 2**32, 4096, dtype=np.uint64)
                            .astype(np.uint32)])
    want = np.asarray(JD.mix32(jnp.asarray(words)))
    got = TD.mix32(_t(words)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # the same hash on plain Python ints (the host-side salt path)
    assert [TD.mix32(int(w)) for w in WORDS] == [int(x) for x in want[:len(WORDS)]]


@pytest.mark.parametrize("ints", [(0,), (7,), (1, 2, 3, 4), (3, 5, 2, 1),
                                  (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),
                                  (123456789, 2**31, 0, 5)])
def test_fold_bit_exact(ints):
    assert TD.fold(*ints) == int(JD.fold(*ints))
    # tensor arguments give the same salt as Python ints
    assert int(TD.fold(*[torch.tensor(v) for v in ints])) == TD.fold(*ints)


def test_uniform01_bit_exact():
    rng = np.random.default_rng(1)
    words = np.concatenate([WORDS, rng.integers(0, 2**32, 4096, dtype=np.uint64)
                            .astype(np.uint32)])
    want = np.asarray(JD._uniform01(jnp.asarray(words)))
    got = TD._uniform01(_t(words)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # never 0 (log stays finite); the top word rounds to exactly 1.0 in
    # float32 (1 - 2**-25 is a tie), in both packages
    assert got.min() > 0.0 and got.max() <= 1.0
    top = WORDS.tolist().index(0xFFFFFFFF)
    assert got[top] == want[top] == 1.0


@pytest.mark.parametrize("shape,offset", [((1000,), 0), ((37, 3), 5),
                                          ((4, 5, 6), 123), ((), 9)])
def test_gaussian_close_to_jax(shape, offset):
    salt = TD.fold(1, 2, 3, 4)
    want = np.asarray(JD.gaussian_from_salt(shape, JD.fold(1, 2, 3, 4), offset))
    got = TD.gaussian_from_salt(shape, salt, offset).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_hash_deterministic():
    a = TD.gaussian_from_salt((1000,), TD.fold(1, 2, 3, 4))
    b = TD.gaussian_from_salt((1000,), TD.fold(1, 2, 3, 4))
    assert torch.equal(a, b)
    c = TD.gaussian_from_salt((1000,), TD.fold(1, 2, 3, 5))
    assert float(torch.max(torch.abs(a - c))) > 0.1


def test_gaussian_stats():
    g = TD.gaussian_from_salt((200_000,), TD.fold(7)).double()
    assert abs(float(g.mean())) < 0.01
    assert abs(float(g.std()) - 1.0) < 0.01
    assert abs(float((g ** 3).mean())) < 0.05
    assert abs(float((g ** 4).mean()) - 3.0) < 0.1


def test_offset_split_consistency():
    salt = TD.fold(42)
    whole = TD.gaussian_from_salt((512,), salt)
    lo = TD.gaussian_from_salt((256,), salt, offset=0)
    hi = TD.gaussian_from_salt((256,), salt, offset=256)
    assert torch.equal(whole, torch.cat([lo, hi]))


def test_counter_wraps_mod_2_32_like_jax():
    """Counters past 2**32 wrap to 0, in both packages."""
    salt = TD.fold(11)
    off = 2**32 - 4
    got = TD.gaussian_from_salt((8,), salt, offset=off)
    assert torch.equal(got[4:], TD.gaussian_from_salt((4,), salt, offset=0))
    want = np.asarray(JD.gaussian_from_salt((8,), JD.fold(11),
                                            jnp.uint32(off)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_sphere_direction_unit_norm_and_matches_jax():
    params = {"a": torch.zeros(100, 7), "b": {"c": torch.zeros(333)}}
    v = TD.sphere_direction(params, seed=0, t=3, worker=1)
    ssq = sum(float(torch.sum(x ** 2)) for x in TD.tree_leaves(v))
    assert abs(ssq - 1.0) < 1e-5
    assert v["a"].shape == (100, 7) and v["b"]["c"].shape == (333,)
    jp = {"a": jnp.zeros((100, 7)), "b": {"c": jnp.zeros((333,))}}
    jv = JD.sphere_direction(jp, 0, jnp.int32(3), jnp.uint32(1))
    for a, b in zip(TD.tree_leaves(v), jax.tree.leaves(jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_workers_and_iterations_get_distinct_directions():
    params = {"a": torch.zeros(64)}
    vs = [TD.sphere_direction(params, 0, 0, i)["a"] for i in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert abs(float(torch.dot(vs[i], vs[j]))) < 0.5, (i, j)
    v1 = TD.sphere_direction(params, 0, 1, 0)["a"]
    assert abs(float(torch.dot(vs[0], v1))) < 0.5


def test_tree_dim_and_axpy():
    params = {"a": torch.ones(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16)}
    assert TD.tree_dim(params) == 17
    v = {"a": torch.full((3, 4), 2.0), "b": torch.ones(5)}
    out = TD.tree_axpy(0.5, v, params)
    assert torch.all(out["a"] == 2.0)
    assert out["b"].dtype == torch.bfloat16 and torch.all(out["b"] == 0.5)


def test_mlp_leaf_order_is_sorted_keys_like_jax():
    """Leaf order is hash identity: the MLP flattens b1,b2,b3,w1,w2,w3 in
    both packages, so leaf i gets the same salt and the same direction."""
    from repro.models.mlp import init_mlp_classifier as jinit
    from repro_torch.models.mlp import init_mlp_classifier as tinit

    jp = jinit(jax.random.key(0), 54, 7, hidden=16)
    tp = tinit(0, 54, 7, hidden=16, device="cpu")
    assert list(tp) == ["w1", "b1", "w2", "b2", "w3", "b3"]   # insertion order
    t_shapes = [tuple(x.shape) for x in TD.tree_leaves(tp)]
    j_shapes = [tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert t_shapes == j_shapes == [(16,), (16,), (7,), (54, 16), (16, 16), (16, 7)]
    assert TD.leaf_salts(tp, 3, 5, 2) == [int(s) for s in
                                         JD.leaf_salts(jp, 3, jnp.int32(5),
                                                       jnp.uint32(2))]
    jv = JD.raw_direction(jp, 3, jnp.int32(5), jnp.uint32(2))
    tv = TD.raw_direction(tp, 3, 5, 2)
    for k in tp:
        np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
