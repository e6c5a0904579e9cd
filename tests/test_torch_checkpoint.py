"""The port's checkpoint (``repro_torch.checkpoint``) against the reference's.

* Across packages, both ways, bit for bit: a tree with bfloat16, float32,
  int32 and int64 leaves, a Python int and nested dicts and lists, saved by
  one package, restores in the other with every value and logical dtype
  (bfloat16 stays bfloat16; the Python int comes back as int64).  The two
  manifests are the same bytes.
* The gemma2-2b smoke model's parameters: the port's leaf names are the
  reference's ``jax.tree_util.keystr`` strings, in the same order.
* ``manifest.pack`` is byte-identical to ``msgpack.packb`` on a manifest and
  on every int, str, list and map width edge (fixint, uint8..64, negative
  fixint, int8..64, fixstr, str8/16, fixarray, array16, fixmap, map16), and
  ``unpack`` returns what ``msgpack.unpackb`` does; types outside the subset
  raise.
* ``latest_step``, an atomic overwrite, the ``.tmp_`` directory removed after
  a failing save, and ``ValueError`` on a tree mismatch (the reference's
  tests/test_checkpoint_data.py).
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.checkpoint import latest_step, manifest, restore, save
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

msgpack = pytest.importorskip("msgpack")


def _numpy_tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
        "layers": {"b": rng.normal(size=(7,)).astype(np.float32),
                   "idx": rng.integers(-9, 9, size=(2, 3)).astype(np.int32)},
        "count": [np.array([2 ** 40 + 3, -5], np.int64), 11],
    }


def _torch_tree(t):
    def conv(x):
        if isinstance(x, int):
            return x
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return jax.tree.map(conv, t)


def _jax_tree(t):
    return jax.tree.map(lambda x: x if isinstance(x, int)
                        else (np.asarray(x) if x.dtype.itemsize == 8 else jnp.asarray(x)), t)


def _bits(x) -> np.ndarray:
    """A leaf's bytes as a numpy array of its own width (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_same(got_leaves, want_leaves):
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w) if isinstance(w, int) else w
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape
        np.testing.assert_array_equal(gb, wb)


def test_reference_save_port_restore(tmp_path):
    tree = _numpy_tree()
    jsave(str(tmp_path), 4, _jax_tree(tree))
    got, step = restore(str(tmp_path), _torch_tree(tree))
    assert step == 4
    assert got["w"].dtype == torch.bfloat16 and got["count"][1].dtype == torch.int64
    _assert_same(tree_leaves(got), jax.tree.leaves(_torch_tree(tree)))


def test_port_save_reference_restore(tmp_path):
    tree = _numpy_tree()
    save(str(tmp_path), 4, _torch_tree(tree))
    got, step = jrestore(str(tmp_path), _jax_tree(tree))
    assert step == 4
    assert got["w"].dtype == jnp.bfloat16
    _assert_same(jax.tree.leaves(got), jax.tree.leaves(tree))


def test_manifests_are_the_same_bytes(tmp_path):
    tree = _numpy_tree()
    pj = jsave(str(tmp_path / "j"), 9, _jax_tree(tree))
    pt = save(str(tmp_path / "t"), 9, _torch_tree(tree))
    read = lambda p: open(os.path.join(p, "manifest.msgpack"), "rb").read()  # noqa: E731
    assert read(pt) == read(pj)
    man = msgpack.unpackb(read(pt))
    assert man["dtypes"] == ["int64", "int64", "float32", "int32", "bfloat16"]
    assert man["names"] == ["['count'][0]", "['count'][1]", "['layers']['b']",
                            "['layers']['idx']", "['w']"]


def test_model_leaf_names_match_keystr():
    jcfg, cfg = jget_config("gemma2-2b").reduced(), get_config("gemma2-2b").reduced()
    jp = jax.eval_shape(lambda: JT.init_model(jax.random.key(0), jcfg))
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    names, leaves, _ = C._flatten_with_names(T.init_model(0, cfg, device="cpu"))
    assert names == want
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jax.tree.leaves(jp)]


MANIFEST = {"step": 12, "names": ["['embed']", "['layers']['attn']['wq']", "[0]"],
            "dtypes": ["bfloat16", "float32", "int64"], "shapes": [[256000, 2304], [], [26, 1]]}
EDGES = [0, 1, 127, 128, 255, 256, 2 ** 16 - 1, 2 ** 16, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
         -1, -32, -33, -128, -129, 2 ** 15 - 1, -2 ** 15, -2 ** 15 - 1, -2 ** 31,
         -2 ** 31 - 1, -2 ** 63,
         "", "a" * 31, "a" * 32, "é" * 200, "b" * 256, "c" * 70000,
         [], list(range(15)), list(range(16)), [[i] * 3 for i in range(70000)],
         {f"k{i}": i for i in range(15)}, {f"k{i}": [str(i)] for i in range(16)}]


@pytest.mark.parametrize("obj", [MANIFEST] + EDGES,
                         ids=["manifest"] + [f"edge{i}" for i in range(len(EDGES))])
def test_pack_matches_msgpack(obj):
    want = msgpack.packb(obj)
    assert manifest.pack(obj) == want
    assert manifest.unpack(want) == msgpack.unpackb(want) == obj


@pytest.mark.parametrize("obj", [1.5, True, None, b"x", (1, 2), {1: 2}, [1, [2, 3.0]]])
def test_pack_raises_outside_the_subset(obj):
    with pytest.raises(TypeError):
        manifest.pack(obj)


@pytest.mark.parametrize("data", [msgpack.packb(1.5), msgpack.packb(None), b"\x92\x01",
                                  msgpack.packb(1) + b"\x00"])
def test_unpack_raises_outside_the_subset(data):
    with pytest.raises((TypeError, ValueError)):
        manifest.unpack(data)


def test_latest_step_and_overwrite(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    save(d, 1, {"x": torch.ones(3)})
    save(d, 5, {"x": torch.ones(3)})
    assert latest_step(d) == 5
    save(d, 5, {"x": torch.full((3,), 2.0)})               # atomic overwrite
    got, step = restore(d, {"x": torch.zeros(3)})
    assert step == 5 and torch.equal(got["x"], torch.full((3,), 2.0))
    got, _ = restore(d, {"x": torch.zeros(3)}, step=1)
    assert torch.equal(got["x"], torch.ones(3))
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), {"x": torch.zeros(3)})


def test_failed_save_removes_its_tmp_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    save(d, 1, {"x": torch.ones(3)})

    def broken(obj):
        raise RuntimeError("disk full")

    monkeypatch.setattr(manifest, "pack", broken)
    with pytest.raises(RuntimeError, match="disk full"):
        save(d, 2, {"x": torch.ones(3)})
    assert sorted(os.listdir(d)) == ["step_00000001"]
    assert latest_step(d) == 1


def test_structure_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="tree mismatch"):
        restore(str(tmp_path), {"b": torch.ones(2)})
