"""The port's copy of the config registry equals the JAX package's.

For every architecture id, ``ModelConfig`` field for field
(``dataclasses.asdict``), its ``reduced()`` variant, ``param_count()`` (total
and active) and ``layer_windows()`` (also under ``long_context``): the copies
must not drift.
"""
import dataclasses

import pytest

import repro.configs as J
from repro_torch import configs as T


def test_same_architecture_ids_and_shapes():
    assert T.ARCH_IDS == J.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}


@pytest.mark.parametrize("arch", J.ARCH_IDS)
def test_config_copy_matches_reference(arch):
    t, j = T.get_config(arch), J.get_config(arch)
    for tc, jc in ((t, j), (t.reduced(), j.reduced()),
                   (t.with_(long_context=True), j.with_(long_context=True))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.param_count(active_only=True) == jc.param_count(active_only=True)
        assert tc.layer_windows() == jc.layer_windows()
        assert tc.subquadratic == jc.subquadratic
    for shape in J.SHAPES:
        tc = T.config_for_shape(t, T.SHAPES[shape])
        jc = J.config_for_shape(j, J.SHAPES[shape])
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert T.shape_applicable(t, T.SHAPES[shape]) == J.shape_applicable(j, J.SHAPES[shape])
