"""Sharding-spec contract, in PyTorch: one module owns every placement decision.

Counterpart of ``repro.dist.sharding``.  The decisions are pure functions of
the mesh's axis names and sizes, the config and each leaf's dict path and
shape, so they are copied rule for rule:

* **worker axes** -- the paper's m workers are the ``("pod", "data")`` mesh
  axes (whichever exist).  Param specs never name a worker axis, except under
  ``cfg.fsdp``, where ``data`` also shards weights (ZeRO-style).
* **model axis** -- tensor parallelism: column-parallel projections shard
  their output dim, row-parallel ones their input dim (Megatron convention),
  expert FFNs the hidden dim (``moe_sharding='tensor'``) or the expert dim
  (``'expert'``).
* Every rule is divisibility-guarded: a dim that does not divide the axis
  size is replicated.

A mesh is anything with a ``.shape`` mapping axis name to size (a
``DeviceMesh`` from ``launch.mesh`` is read through its ``mesh_dim_names``),
so the specs can be taken for a 512-rank mesh in one process.  A spec is a
``PartitionSpec``: one entry per tensor dim (an axis name, a tuple of axis
names, or None), trailing Nones dropped, as in JAX.  ``named`` turns a spec
into ``DeviceMesh`` placements.  The port's process-group steps keep
parameters replicated; running the ``model`` axis's placements is ROADMAP
Queue 1 item 11a.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

WORKER_AXIS_ORDER = ("pod", "data")

# column-parallel weights: shard the *last* dim over the model axis
_COL_PARALLEL = {"wq", "wk", "wv", "wg", "wu", "in_proj", "dt_w", "head"}
# row-parallel weights: shard dim -2 (the contraction dim) over the model axis
_ROW_PARALLEL = {"wo", "wd", "out_proj", "x_proj", "A_log"}
# never sharded on the model axis (tiny, or consumed elementwise everywhere)
_REPLICATED = {"router", "conv_w", "conv_b", "dt_b", "D", "scale", "bias",
               "q_norm", "k_norm", "attn_out_scale", "mamba_out_scale"}


class PartitionSpec:
    """Per-dim placement of one tensor; a leaf of the port's trees (not a
    tuple, which ``repro_torch.tree`` would flatten)."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self) -> Iterator:
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of anything with a ``.shape``
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def worker_axes(mesh) -> Tuple[str, ...]:
    """The worker axes: ``("pod", "data")`` ∩ mesh, in that order."""
    shape = mesh_shape(mesh)
    return tuple(a for a in WORKER_AXIS_ORDER if a in shape)


def n_workers(mesh) -> int:
    """m -- the paper's worker count -- for this mesh."""
    shape, n = mesh_shape(mesh), 1
    for a in worker_axes(mesh):
        n *= shape[a]
    return n


def worker_index(mesh) -> int:
    """This rank's worker id on a ``DeviceMesh``: its coordinates on the
    worker axes, flattened in their order (``pod_idx * n_data + data_idx``)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shape, w = mesh_shape(mesh), 0
    for a in worker_axes(mesh):
        w = w * shape[a] + coord[a]
    return w


def _with_paths(tree: Any, names: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(dict-key path, leaf) in ``tree_flatten`` order; list and tuple
    positions add no name (the reference keeps ``DictKey``s only)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_paths(tree[k], names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _with_paths(x, names)
    elif tree is not None:
        yield names, tree


def _map_with_paths(fn, tree: Any) -> Any:
    _, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(names, x) for names, x in _with_paths(tree)])


def _leaf_spec(cfg, shape_of: Dict[str, int], names: Tuple[str, ...], shape) -> PartitionSpec:
    """Spec for one parameter leaf, identified by its dict path."""
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    off = 1 if names and names[0] == "layers" else 0   # stacked (L, ...) leaves
    ndim = len(shape)
    parts: List = [None] * ndim
    ms = shape_of.get("model", 1)
    ds = shape_of.get("data", 1)
    fsdp = bool(getattr(cfg, "fsdp", False)) and "data" in shape_of

    def put(dim: int, axis: str, size: int) -> bool:
        if 0 <= dim < ndim and parts[dim] is None and shape[dim] % size == 0:
            parts[dim] = axis
            return True
        return False

    # model axis: tensor parallelism
    if "model" in shape_of and name not in _REPLICATED and ndim - off >= 2:
        is_expert = parent == "moe" and name in ("wg", "wu", "wd")
        if is_expert and getattr(cfg, "moe_sharding", "tensor") == "expert":
            put(off, "model", ms)                    # expert-parallel: E dim
        elif name == "embed":
            put(ndim - 2, "model", ms)               # vocab rows over model
        elif name in _COL_PARALLEL:
            put(ndim - 1, "model", ms)
        elif name in _ROW_PARALLEL:
            put(ndim - 2, "model", ms)

    # data axis: ZeRO/FSDP weight sharding (cfg.fsdp only)
    if fsdp and ndim - off >= 1 and name != "router":
        if parent == "moe" and name in ("wg", "wu", "wd"):
            put(off, "data", ds)                     # expert dim over data
        else:
            # largest still-unsharded dim (ties -> earliest), vectors included
            for dim in sorted(range(off, ndim), key=lambda i: (-shape[i], i)):
                if put(dim, "data", ds):
                    break

    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def param_specs(cfg, params: Any, mesh) -> Any:
    """PartitionSpec tree for a parameter tree (any leaves with a ``.shape``:
    tensors, meta tensors).  Names ``model`` always, ``data`` only under
    ``cfg.fsdp``, never ``pod``."""
    shape_of = mesh_shape(mesh)
    return _map_with_paths(
        lambda names, x: _leaf_spec(cfg, shape_of, names, tuple(x.shape)), params)


def batch_specs(mesh, batch: Any) -> Any:
    """Shard every batch leaf's leading dim over the worker axes; leaves whose
    leading dim the worker count does not divide (and 0-d leaves) are
    replicated."""
    wa, m = worker_axes(mesh), n_workers(mesh)

    def spec(x) -> PartitionSpec:
        shape = tuple(getattr(x, "shape", ()))
        if not wa or not shape or shape[0] % m:
            return PartitionSpec()
        return PartitionSpec(wa)

    return tree_map(spec, batch)


def cache_specs(cfg, mesh, caches: Any, seq_sharded: bool = False) -> Any:
    """Decode/prefill cache specs (stacked per-layer trees).

    * ``k``/``v`` (L, B, S, KV, hd): batch over the worker axes; the kv-head
      dim over ``model``, falling back to head_dim when KV does not divide.
    * ``conv`` (L, B, K-1, di) / ``ssm`` (L, B, di, n): batch over workers,
      d_inner over ``model``.
    * ``seq_sharded`` (long_500k, batch=1): the attention cache's sequence
      dim carries the worker axes instead of batch.
    """
    shape_of = mesh_shape(mesh)
    wa, m = worker_axes(mesh), n_workers(mesh)
    ms = shape_of.get("model", 1)

    def spec(names, x) -> PartitionSpec:
        name = names[-1] if names else ""
        shape = tuple(x.shape)
        parts: List = [None] * len(shape)
        if name in ("k", "v") and len(shape) == 5:
            _, B, S, KV, hd = shape
            if seq_sharded:
                if wa and S % m == 0:
                    parts[2] = wa
            elif wa and B % m == 0:
                parts[1] = wa
            if "model" in shape_of:
                if KV % ms == 0 and ms > 1:
                    parts[3] = "model"
                elif hd % ms == 0:
                    parts[4] = "model"
        elif name == "conv" and len(shape) == 4:
            if wa and not seq_sharded and shape[1] % m == 0:
                parts[1] = wa
            if "model" in shape_of and shape[3] % ms == 0:
                parts[3] = "model"
        elif name == "ssm" and len(shape) == 4:
            if wa and not seq_sharded and shape[1] % m == 0:
                parts[1] = wa
            if "model" in shape_of and shape[2] % ms == 0:
                parts[2] = "model"
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    return _map_with_paths(spec, caches)


def named(mesh, spec_tree: Any) -> Any:
    """Map a PartitionSpec tree to ``DeviceMesh`` placements (the reference's
    ``NamedSharding``s): per spec, one placement per mesh dim in the mesh's
    order, ``Shard(d)`` where tensor dim d names that axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    def placements(spec: PartitionSpec) -> tuple:
        out = []
        for axis in mesh_shape(mesh):
            dims = [d for d, part in enumerate(spec)
                    if part == axis or (isinstance(part, tuple) and axis in part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    return tree_map(placements, spec_tree)
