"""The collectives the reference's compiler emits for the partitioned mixer
and for attention, on a (data=1, model=2) CPU mesh: what the port's
partitioned layers (``repro_torch.models.ssm``, ``.attention``) mirror.

Lowers, under the reference's own placements (``repro.dist.sharding``'s
``param_specs`` and ``cache_specs``) and with the mesh's axes Auto:

* falcon-mamba-7b's mixer at its reduced widths (D=256, d_inner=512):
  ``mamba_forward``, its gradient (of the output's sum, w.r.t. the
  parameters and x) and ``mamba_decode``;
* hymba-1.5b's attention at full width (25 query and 5 KV heads, hd 64):
  ``attention_decode`` at one position of an ``hd``-cut cache,
  ``attention_prefill``, ``attention_forward`` and its gradient (of the
  output's sum, w.r.t. the parameters and x),

in float32, B=2, S=64, and prints each program's collective instructions
(``.compile().as_text()``), one per line: the kind and the result's shape,
a tuple of shapes where one instruction carries several arrays.  The reference runs on the CPU
only; nothing of it changes.

    PYTHONPATH=src python tests/helpers/reference_collectives.py [mixer] [attention]

(both parts without an argument).  ``tests/test_torch_kept_cut.py`` runs
the attention part and holds the port's collectives to what it prints.
"""
import os
import re
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.dist.sharding import cache_specs, named, param_specs  # noqa: E402
from repro.models import attention as A  # noqa: E402
from repro.models import ssm as M  # noqa: E402

#: an instruction's result shape (one array, or a tuple of them) and kind
COLLECTIVE = re.compile(r"= (\([^()]*\)|\S+) (all-gather|all-reduce|collective-permute|"
                        r"reduce-scatter|all-to-all)(-start)?\(")
B, S = 2, 64


def collectives(fn, *args, in_shardings):
    """The collective instructions of ``fn`` compiled for ``args``:
    ``(kind, result shape)`` in program order (the shape as the HLO text
    writes it, ``(f32[..], f32[..])`` for a tuple)."""
    text = jax.jit(fn, in_shardings=in_shardings).lower(*args).compile().as_text()
    return [(m.group(2), m.group(1)) for m in COLLECTIVE.finditer(text)]


def show(name, found):
    print(f"{name}: {len(found)} collectives")
    for kind, shape in found:
        print(f"  {kind} {shape}")


def main(parts=("mixer", "attention")):
    assert jax.device_count() == 2, jax.device_count()
    auto = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=auto)
    if "mixer" in parts:
        mixer(mesh)
    if "attention" in parts:
        attention(mesh)


def mixer(mesh):
    rep = NamedSharding(mesh, P())
    key = jax.random.key(0)
    cfg = get_config("falcon-mamba-7b").reduced()
    p = M.init_mamba(key, cfg, jnp.float32)
    ps = named(mesh, param_specs(cfg, p, mesh))
    x = jax.random.normal(key, (B, S, cfg.d_model), jnp.float32)
    state = M.init_mamba_state(cfg, B, jnp.float32)
    st = (NamedSharding(mesh, P(None, None, "model")), NamedSharding(mesh, P(None, "model")))
    print(f"mixer: falcon-mamba-7b reduced, D={cfg.d_model} d_inner={cfg.d_inner}, "
          f"in_proj {param_specs(cfg, p, mesh)['in_proj']}, B={B} S={S}")
    with compat.set_mesh(mesh):
        show("mamba_forward", collectives(lambda p, x: M.mamba_forward(cfg, p, x), p, x,
                                          in_shardings=(ps, rep)))
        grad = jax.grad(lambda p, x: M.mamba_forward(cfg, p, x).sum(), argnums=(0, 1))
        show("grad of mamba_forward", collectives(grad, p, x, in_shardings=(ps, rep)))
        show("mamba_decode", collectives(lambda p, x, s: M.mamba_decode(cfg, p, x, s), p,
                                         x[:, :1], state, in_shardings=(ps, rep, st)))


def attention(mesh):
    rep = NamedSharding(mesh, P())
    key = jax.random.key(0)
    cfg = get_config("hymba-1.5b")
    p = A.init_attention(key, cfg, jnp.float32)
    ps = named(mesh, param_specs(cfg, p, mesh))
    x = jax.random.normal(key, (B, S, cfg.d_model), jnp.float32)
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    cspec = cache_specs(cfg, mesh, {"k": jax.ShapeDtypeStruct((1, *shape), jnp.float32)})["k"]
    cs = NamedSharding(mesh, P(*tuple(cspec)[1:]))
    cache = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    print(f"attention: hymba-1.5b, H={cfg.n_heads} KV={cfg.n_kv_heads} hd={cfg.head_dim}, "
          f"cache {P(*tuple(cspec)[1:])}, B={B} S={S}")
    with compat.set_mesh(mesh):
        show("attention_decode", collectives(
            lambda p, x, c: A.attention_decode(cfg, p, x, c, jnp.int32(S - 1)), p, x[:, :1],
            cache, in_shardings=(ps, rep, (cs, cs))))
        show("attention_prefill", collectives(lambda p, x: A.attention_prefill(cfg, p, x), p,
                                              x, in_shardings=(ps, rep)))
        show("attention_forward", collectives(lambda p, x: A.attention_forward(cfg, p, x), p,
                                              x, in_shardings=(ps, rep)))
        grad = jax.grad(lambda p, x: A.attention_forward(cfg, p, x).sum(), argnums=(0, 1))
        show("grad of attention_forward", collectives(grad, p, x, in_shardings=(ps, rep)))


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("mixer", "attention"))
