"""``repro_torch.launch.specs`` against ``repro.launch.specs``: the dry run's
stand-ins for every architecture and every shape that applies to it.

For each (arch, shape): the port's ``abstract_params`` (meta tensors made
through ``init_model`` under a ``FakeTensorMode``), ``train_batch_structs``
(with and without labels) and ``decode_structs`` (the full-length caches)
leaf for leaf equal to the reference's ``jax.eval_shape`` structs in shape
and dtype, in ``jax.tree.leaves`` order; ``model_flops`` and
``param_count`` (all and active) equal; ``input_specs`` hands back the
placements of ``dist.sharding`` for its stand-ins.  Nothing is allocated:
every stand-in lies on the ``meta`` device.
"""
import os

import jax
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import config_for_shape as jconfig_for_shape
from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs

# the reference's dry run sets XLA_FLAGS (512 host devices) at import, for
# its own process; a test process keeps its environment
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS
from repro_torch.configs import ARCH_IDS, SHAPES, config_for_shape, get_config, shape_applicable
from repro_torch.dist.sharding import PartitionSpec, batch_specs, cache_specs, param_specs
from repro_torch.launch import dryrun, specs
from repro_torch.tree import tree_leaves

import torch_dist_helpers as H

CASES = [(a, s) for a in ARCH_IDS for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])[0]]


def _port(tree):
    leaves = tree_leaves(tree)
    assert all(x.device.type == "meta" for x in leaves)
    return [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in leaves]


def _ref(tree):
    return [(tuple(x.shape), x.dtype.name) for x in jax.tree.leaves(tree)]


def _cfgs(arch, shape):
    return (config_for_shape(get_config(arch), SHAPES[shape]),
            jconfig_for_shape(jget_config(arch), JSHAPES[shape]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert _port(specs.abstract_params(cfg)) == _ref(jspecs.abstract_params(jcfg))
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(True) == jcfg.param_count(True)


@pytest.mark.parametrize("arch,shape", CASES)
def test_batches_and_caches_match_the_reference(arch, shape):
    cfg, jcfg = _cfgs(arch, shape)
    sh, jsh = SHAPES[shape], JSHAPES[shape]
    assert jdryrun.model_flops(jcfg, jsh) == dryrun.model_flops(cfg, sh)
    assert dryrun.step_kinds(sh) == jdryrun.step_kinds(jsh)
    for labels in (True, False):
        got = specs.train_batch_structs(cfg, sh, with_labels=labels)
        want = jspecs.train_batch_structs(jcfg, jsh, with_labels=labels)
        assert sorted(got) == sorted(want)
        assert _port(got) == _ref(want)
    if sh.kind == "decode":
        token, pos, caches = specs.decode_structs(cfg, sh)
        jtoken, jpos, jcaches = jspecs.decode_structs(jcfg, jsh)
        assert _port(token) == _ref(jtoken)
        assert pos == sh.seq_len - 1 and jpos.shape == ()
        assert sorted(caches) == sorted(jcaches)
        assert _port(caches) == _ref(jcaches)


@pytest.mark.parametrize("kind,shape", [("train", "train_4k"), ("prefill", "prefill_32k"),
                                        ("decode", "decode_32k"), ("decode", "long_500k")])
def test_input_specs_place_the_stand_ins(kind, shape):
    cfg = config_for_shape(get_config("gemma2-2b"), SHAPES[shape])
    mesh = H.FakeMesh(dict(data=0, model=0), data=16, model=16)
    args, placed = specs.input_specs(cfg, SHAPES[shape], mesh, kind)
    params = args[0] if kind != "train" else args[1]
    assert placed[0 if kind != "train" else 1] == param_specs(cfg, params, mesh)
    if kind == "decode":
        caches = args[3]
        assert placed[3] == cache_specs(cfg, mesh, caches, seq_sharded=shape == "long_500k")
        want_tok = (PartitionSpec() if SHAPES[shape].global_batch % 16
                    else PartitionSpec(("data",)))
        assert placed[1] == want_tok
        if shape == "long_500k":
            assert placed[3]["k"][2] == ("data",)
    else:
        batch = args[-1]
        assert placed[-1] == batch_specs(mesh, batch)
        assert all(x.device.type == "meta" for x in tree_leaves(batch))
