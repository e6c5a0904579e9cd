"""The port's sharding specs against ``repro.dist.sharding``, on the CPU.

The spec decisions are pure functions of the mesh's axis names and sizes,
the config and the leaves' paths and shapes, so the port's are held equal to
the reference's, spec for spec, for every config on the 16x16, 2x16x16 and
4x2 meshes with ``fsdp`` on and off: ``param_specs`` (the port given meta
tensors of the reference's abstract parameter shapes), ``cache_specs``
(batch- and sequence-sharded), ``batch_specs``, ``worker_axes`` and
``n_workers``.  The reference meshes are built here as
``AbstractMesh(axis_sizes, axis_names)``: its own tests/test_dist_sharding.py
builds them with an older signature and fails at collection on this jax.
Its pins (tensor- and row-parallel rules, the divisibility guard, fsdp's data
axis, the MoE expert dim over data, batch and cache specs) are what the port
is held to here through the equality, and a few directly; a one-axis tuple
and its axis compare equal, as newer jax stores them.  ``named`` maps a spec
to ``DeviceMesh`` placements.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.dist import sharding as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.dist import sharding as S
from repro_torch.dist.sharding import P


def abstract_mesh(**axes):
    names, sizes = tuple(axes), tuple(axes.values())
    try:
        return AbstractMesh(sizes, names)
    except TypeError:                      # jax < 0.5: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(names, sizes)))


MESHES = {"16x16": abstract_mesh(data=16, model=16),
          "2x16x16": abstract_mesh(pod=2, data=16, model=16),
          "4x2": abstract_mesh(data=4, model=2)}


def canon(part):
    """A one-axis tuple as its axis: newer jax's ``PartitionSpec`` stores
    ``("data",)`` as ``"data"``, the same placement."""
    return part[0] if isinstance(part, tuple) and len(part) == 1 else part


def as_tuples(spec_tree):
    """{path: spec as a tuple} of a reference or port spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, (S.PartitionSpec, jax.sharding.PartitionSpec)))
    return {jax.tree_util.keystr(path): tuple(canon(p) for p in s) for path, s in flat}


def meta(tree):
    return jax.tree.map(lambda x: torch.empty(x.shape, device="meta"), tree)


@pytest.fixture(scope="module")
def abstract_params():
    return {a: jax.eval_shape(lambda k, c=jget_config(a): JT.init_model(k, c), jax.random.key(0))
            for a in ARCH_IDS}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_equal_reference_for_every_config(abstract_params, mesh, fsdp):
    am = MESHES[mesh]
    for arch in ARCH_IDS:
        jcfg, cfg = jget_config(arch).with_(fsdp=fsdp), get_config(arch).with_(fsdp=fsdp)
        want = as_tuples(JS.param_specs(jcfg, abstract_params[arch], am))
        got = as_tuples(S.param_specs(cfg, meta(abstract_params[arch]), am))
        assert got == want, arch
        named = {a for spec in got.values() for part in spec
                 for a in ((part,) if isinstance(part, str) else (part or ()))}
        assert "pod" not in named and ("data" in named) <= fsdp, arch


def test_param_specs_reference_pins():
    """tests/test_dist_sharding.py's pins, on the port."""
    pod = MESHES["16x16"]

    def by(arch, mesh=pod, **kw):
        cfg = get_config(arch).with_(**kw) if kw else get_config(arch)
        params = meta(jax.eval_shape(lambda k: JT.init_model(k, jget_config(arch).with_(**kw)),
                                     jax.random.key(0)))
        return as_tuples(S.param_specs(cfg, params, mesh))

    g = by("gemma2-2b")
    assert g["['layers']['attn']['wq']"] == (None, None, "model")
    assert g["['layers']['attn']['wo']"] == (None, "model")
    assert g["['layers']['norm1']['scale']"] == () and g["['embed']"] == ("model",)
    assert by("qwen3-14b")["['head']"] == (None, "model")
    moe = by("qwen3-moe-235b-a22b", fsdp=True)
    assert moe["['layers']['moe']['wg']"] == (None, "data", None, "model")
    assert moe["['layers']['moe']['wd']"] == (None, "data", "model")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_worker_axes_and_batch_specs_equal_reference(mesh):
    am = MESHES[mesh]
    assert S.worker_axes(am) == JS.worker_axes(am)
    assert S.n_workers(am) == JS.n_workers(am)
    shapes = {"tokens": (64, 128), "labels": (64, 128), "odd": (7, 128), "pos": ()}
    got = S.batch_specs(am, {k: torch.empty(s, device="meta") for k, s in shapes.items()})
    want = JS.batch_specs(am, {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()})
    assert as_tuples(got) == as_tuples(want)
    if S.worker_axes(am) == ("data",):
        assert tuple(got["tokens"]) == (("data",),)    # the reference's own pin
    lone = abstract_mesh(model=4)
    assert S.worker_axes(lone) == () and S.n_workers(lone) == 1


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_specs_equal_reference(mesh, seq_sharded):
    am = MESHES[mesh]
    for arch in ARCH_IDS:
        jcfg, cfg = jget_config(arch), get_config(arch)
        B, S_ = (1, 1 << 19) if seq_sharded else (128, 4096)
        caches = jax.eval_shape(lambda: JT.init_caches(jcfg, B, S_, jnp.bfloat16))
        want = as_tuples(JS.cache_specs(jcfg, am, caches, seq_sharded=seq_sharded))
        got = as_tuples(S.cache_specs(cfg, am, meta(caches), seq_sharded=seq_sharded))
        assert got == want, arch


def test_named_maps_specs_to_device_mesh_placements():
    from torch.distributed.tensor import Replicate, Shard

    am = MESHES["2x16x16"]
    tree = {"w": P(None, "model"), "b": P(), "x": P(("pod", "data"))}
    got = S.named(am, tree)
    assert got["w"] == (Replicate(), Replicate(), Shard(1))
    assert got["b"] == (Replicate(),) * 3
    assert got["x"] == (Shard(0), Shard(0), Replicate())
    spec = P(None, ("pod", "data"), "model")
    assert len(spec) == 3 and spec[1] == ("pod", "data") and list(spec)[2] == "model"
    assert spec == P(None, ("pod", "data"), "model") and spec != P(None)
