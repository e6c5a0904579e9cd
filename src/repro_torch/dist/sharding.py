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
into ``DeviceMesh`` placements.

Running the placements (the port's formulation: the ``model`` axis
partitions the compute, every other axis is storage).  A rank holds plain
local tensors, its shard of every leaf: a dim that a spec names is cut into
as many equal parts as its axes have ranks, and the rank keeps the part at
its coordinate on them (``shard_slices``; several axes flattened major to
minor).  ``ShardGeometry`` holds every leaf's slice, the global d and the
shard as runs of consecutive global row-major indices (``leaf_runs``),
which is how the direction engines keep the hash's counters global.
``Sharder`` cuts each leaf as it is made (the trainer's initialisation),
``shard_tree`` a whole tree, ``gather`` a leaf back over the axes its spec
names (or a subset of them) and ``gather_tree`` a whole tree.

``ShardedParams`` is what the transformer runs with.  Each layer's leaves
(and the embedding, head and final norm) are gathered over the storage axes
only (``data`` under fsdp: ZeRO storage) just before they are used; the
``model`` cut stays, and the layers compute on it by Megatron's convention,
through the group of the ``model`` axis (``ModelAxis``): a column-parallel
product on the cut output dim, whose input enters through ``enter``
(identity forward, all-reduce of the gradient backward), and a
row-parallel product on the cut contraction dim, computed in float32 on
every rank and summed through ``reduce`` (all-reduce forward, identity
backward), once per sublayer.  Replicated leaves used on a rank's part
(attention's ``q_norm``/``k_norm``, the mamba mixer's ``conv_w``,
``conv_b``, ``dt_b`` and ``D``) enter too, so that their gradient is the
whole one on every rank.  ``gather`` is differentiable, and its backward is
this rank's slice of the gradient: that is right for a storage axis (every
rank that shares a leaf's shards computed the same full gradient).  No
weight is gathered over ``model``: where a rank needs other ranks'
columns of a column-parallel product, it takes the products, and the
weight stays cut.  The mixer takes only the pieces of u and z it needs
(``in_proj`` cut on ``2·di``, ``ModelAxis.exchange``).  Attention, where
the axis cuts ``wq``, ``wk`` or ``wv`` inside a head, gathers the q, k and
v products whole (``ModelAxis.cat``, its gradient this rank's slice),
runs every head on every rank, and takes this rank's columns of the
output for its rows of ``wo`` (``ModelAxis.split``, its gradient
gathered).  Serving runs on the same placements: a rank's caches are its
slices of ``cache_specs`` over ``model`` (``cache_slices``), and
``ModelAxis.cat`` gathers what a rank needs whole (the logits' vocabulary
columns; on an ``hd``-cut cache the q, k and v products and the attention
output, never the cache).  A sequence-sharded cache (``long_500k``)
is also cut on its sequence over the worker axes (``SequenceAxis``, carried
by ``ShardedParams(..., seq_sharded=True)``).  Nothing here is a ``DTensor``: the
models launch kernels on raw pointers, and gloo carries a CUDA payload only
through host memory (``dist.collectives``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

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


def map_with_paths(fn, tree: Any) -> Any:
    """``fn(dict-key path, leaf)`` on every leaf, in ``tree_flatten`` order."""
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
    return map_with_paths(
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

    return map_with_paths(spec, caches)


def cache_slices(cfg, mesh, caches: Dict[str, Any], seq_sharded: bool = False
                 ) -> Dict[str, Tuple[slice, ...]]:
    """This rank's slice of every leaf of a cache tree of whole shapes
    (tensors or meta tensors), through ``shard_slices``: ``cache_specs``'
    cut over ``model``, and with ``seq_sharded`` also its cut of k's and v's
    sequence dim over the worker axes (``SequenceAxis``).  The worker axes'
    cut of the batch is not taken: every rank of the ``model`` axis serves
    the same slots, and a sequence-sharded cache's conv and ssm states are
    the same on every rank of the worker axes, as the reference's spec
    leaves them."""
    sizes, coord = mesh_shape(mesh), mesh_coordinate(mesh)
    specs = cache_specs(cfg, mesh, caches, seq_sharded)

    def kept(name: str, dim: int, part):
        seq = seq_sharded and name in ("k", "v") and dim == 2
        return part if seq or ModelAxis.name in spec_axes(part) else None

    return {name: shard_slices(PartitionSpec(*(kept(name, d, p)
                                                for d, p in enumerate(specs[name]))),
                               tuple(x.shape), sizes, coord)
            for name, x in caches.items()}


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


# --------------------------------------------------------------------------- #
# running the placements: shard geometry, shards and gathers
# --------------------------------------------------------------------------- #
MASK = 0xFFFFFFFF


def spec_axes(part) -> Tuple[str, ...]:
    """The axes one entry of a spec names: ``()``, ``(axis,)`` or the tuple."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def mesh_coordinate(mesh) -> Dict[str, int]:
    """{axis name: this rank's coordinate} on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def shard_slices(spec: PartitionSpec, shape: Sequence[int], sizes: Dict[str, int],
                 coord: Dict[str, int]) -> Tuple[slice, ...]:
    """This rank's slice of every dim of a leaf of global ``shape``: a dim
    that ``spec`` names is cut into as many equal parts as its axes have
    ranks, and the rank keeps part ``idx``, its coordinates on those axes
    flattened major to minor (the group-rank order of ``gather``)."""
    out = []
    for dim, n in enumerate(shape):
        k, idx = 1, 0
        for a in spec_axes(spec[dim] if dim < len(spec) else None):
            k, idx = k * sizes[a], idx * sizes[a] + coord[a]
        if n % k:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide into {k} parts "
                             f"({spec})")
        step = n // k
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def leaf_runs(shape: Sequence[int], slices: Sequence[slice]) -> Tuple[np.ndarray, int]:
    """``(starts, length)``: the shard of a leaf of global ``shape``, read in
    row-major order, as runs of consecutive global row-major indices, each
    ``length`` long and starting at ``starts`` (int64, unwrapped: a
    counter is the index mod 2**32).  A whole leaf is one run; a leaf cut on
    its last cut dim k has one run per index of the dims before k."""
    shape = [int(n) for n in shape]
    cut = [d for d, (n, sl) in enumerate(zip(shape, slices)) if sl.stop - sl.start != n]
    if not cut:
        return np.zeros(1, np.int64), max(1, math.prod(shape))
    k = cut[-1]
    strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    starts = np.asarray(slices[k].start * strides[k], np.int64)
    for d in range(k):
        starts = starts[..., None] + np.arange(slices[d].start, slices[d].stop,
                                               dtype=np.int64) * strides[d]
    return starts.reshape(-1), (slices[k].stop - slices[k].start) * strides[k]


class ShardGeometry:
    """Where this rank's part of every leaf of a parameter tree lies.

    Built from a spec tree (or a list of specs, None for replicated), the
    leaves' GLOBAL shapes, the mesh's axis sizes and this rank's
    coordinates; ``mesh`` (a ``DeviceMesh``) is needed only by the
    collectives (``reduce_sums``).  A leaf is sharded when its spec names an
    axis of more than one rank; ``sharded`` says whether any leaf is, and
    ``shard_axes`` are the axes that shard some leaf, in the mesh's order.
    ``dim`` is the global d."""

    def __init__(self, specs: Any, shapes: Sequence[Sequence[int]], sizes: Dict[str, int],
                 coord: Dict[str, int], mesh=None):
        specs = list(specs) if isinstance(specs, (list, tuple)) else tree_leaves(specs)
        if len(specs) != len(shapes):
            raise ValueError(f"{len(specs)} specs for {len(shapes)} leaves")
        self.specs = [s if s is not None else PartitionSpec() for s in specs]
        self.shapes = [tuple(int(n) for n in s) for s in shapes]
        self.sizes, self.coord, self.mesh = dict(sizes), dict(coord), mesh
        self.slices = [shard_slices(s, shape, self.sizes, self.coord)
                       for s, shape in zip(self.specs, self.shapes)]
        self.local_shapes = [tuple(sl.stop - sl.start for sl in s) for s in self.slices]
        self.axes = [tuple(a for part in s for a in spec_axes(part) if self.sizes[a] > 1)
                     for s in self.specs]
        self.shard_axes = tuple(a for a in self.sizes if any(a in ax for ax in self.axes))
        self.sharded = bool(self.shard_axes)
        self.dim = sum(math.prod(s) for s in self.shapes)

    @classmethod
    def from_global(cls, specs: Any, params_like: Any, mesh) -> "ShardGeometry":
        """From a tree of global shapes (tensors or meta tensors)."""
        return cls(specs, [tuple(x.shape) for x in tree_leaves(params_like)],
                   mesh_shape(mesh), mesh_coordinate(mesh), mesh)

    @classmethod
    def from_local(cls, specs: Any, shards: Any, mesh) -> "ShardGeometry":
        """From a tree of this rank's shards: every named dim times its
        axes' ranks."""
        sizes = mesh_shape(mesh)
        specs = list(specs) if isinstance(specs, (list, tuple)) else tree_leaves(specs)
        shapes = []
        for s, x in zip(specs, tree_leaves(shards)):
            s = s if s is not None else PartitionSpec()
            shapes.append(tuple(n * math.prod(sizes[a] for a in spec_axes(
                s[d] if d < len(s) else None)) for d, n in enumerate(x.shape)))
        return cls(specs, shapes, sizes, mesh_coordinate(mesh), mesh)

    def runs(self, i: int) -> Tuple[np.ndarray, int]:
        """Leaf i's shard as runs of consecutive global indices (``leaf_runs``)."""
        return leaf_runs(self.shapes[i], self.slices[i])

    def counters(self, i: int, device) -> torch.Tensor:
        """Leaf i's shard's global row-major indices mod 2**32, int64 in the
        local shape: the hash counter of every element."""
        idx = torch.zeros((), dtype=torch.int64, device=device)
        for n, sl in zip(self.shapes[i], self.slices[i]):
            idx = idx[..., None] * n + torch.arange(sl.start, sl.stop, dtype=torch.int64,
                                                    device=device)
        return idx & MASK

    def shard(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf i's part of its whole value ``x``, in storage of its own."""
        if self.local_shapes[i] == tuple(x.shape):
            return x
        return x[self.slices[i]].clone(memory_format=torch.contiguous_format)

    def global_nbytes(self, tree: Any) -> int:
        """The bytes of the global tree whose shards (or whose shards'
        like, in their dtypes) ``tree`` holds."""
        return sum(math.prod(s) * x.element_size()
                   for s, x in zip(self.shapes, tree_leaves(tree)))

    def reduce_sums(self, partials: torch.Tensor, tag: str = "sumsq") -> torch.Tensor:
        """``(k, n_leaves)`` per-leaf partial sums over this rank's shards ->
        ``(k,)`` global sums, the same on every rank: one all-gather of the
        table over ``shard_axes`` (booked ``payload=False``), then, for each
        leaf, its distinct shards (the ranks at coordinate 0 on the shard
        axes that do not cut it) summed in group-rank order, and the leaves
        summed in leaf order."""
        from repro_torch.dist import collectives as coll

        if not self.sharded:
            return partials.sum(-1)
        table = coll.all_gather(partials, self.shard_axes, mesh=self.mesh, tag=tag,
                                payload=False)                       # (g, k, L)
        pos = np.stack(np.meshgrid(*[np.arange(self.sizes[a]) for a in self.shard_axes],
                                   indexing="ij"), -1).reshape(-1, len(self.shard_axes))
        total = None
        for i, axes in enumerate(self.axes):
            keep = [r for r, c in enumerate(pos)
                    if all(c[j] == 0 for j, a in enumerate(self.shard_axes) if a not in axes)]
            leaf = table[keep[0], :, i]
            for r in keep[1:]:
                leaf = leaf + table[r, :, i]
            total = leaf if total is None else total + leaf
        return total


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's shard of every leaf of a whole tree (``ShardGeometry.shard``)."""
    geom = ShardGeometry.from_global(specs, tree, mesh)
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [geom.shard(i, x) for i, x in enumerate(leaves)])


class _GatherDim(torch.autograd.Function):
    """One dim of ``gather``: the parts over ``axes`` concatenated on
    ``dim``; backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh, index, label):
        from repro_torch.dist import collectives as coll

        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return coll.gather_cat(x, axes, mesh=mesh, dim=dim, label=label)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None, None


def gather(x: torch.Tensor, spec: PartitionSpec, mesh,
           axes: Sequence[str] = None) -> torch.Tensor:
    """The leaf from this rank's shard ``x`` with every dim that ``spec``
    cuts over axes of more than one rank all-gathered over them, in dim
    order (``axes``: only the dims that name those axes, the others' cut
    kept); differentiable (``_GatherDim``).  A leaf that no axis cuts comes
    back as itself."""
    sizes, coord = mesh_shape(mesh), None
    for dim in range(min(len(spec), x.dim())):
        names = tuple(a for a in spec_axes(spec[dim]) if sizes[a] > 1)
        if not names or (axes is not None and not set(names) <= set(axes)):
            continue
        coord = coord or mesh_coordinate(mesh)
        index = 0
        for a in names:
            index = index * sizes[a] + coord[a]
        x = _GatherDim.apply(x, dim, names, mesh, index, None)
    return x


def gather_tree(tree: Any, specs: Any, mesh, axes: Sequence[str] = None) -> Any:
    """Every leaf of a tree of shards gathered (``gather``)."""
    return tree_map(lambda x, s: gather(x, s, mesh, axes), tree, specs)


class _Enter(torch.autograd.Function):
    """Where a replicated tensor enters a rank's part of a sublayer: the
    identity; backward: the gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.sum(g), None


class _Reduce(torch.autograd.Function):
    """Where the ranks' partial outputs leave a sublayer: their sum over
    the axis; backward: the identity (the sum is replicated)."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Parts(torch.autograd.Function):
    """Every rank's tensor stacked in rank order, for a combine that every
    rank computes alike; backward: this rank's row of the gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        from repro_torch.dist import collectives as coll

        ctx.rank = axis.rank
        return coll.reduce_parts(x, axis.name, mesh=axis.mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


class _Exchange(torch.autograd.Function):
    """``collectives.exchange`` over a ``ModelAxis``: this rank's pieces of
    the ranks' tensors; backward: each piece's gradient back in its owner's
    slice, an exchange over the ``collectives.transposed`` plan."""

    @staticmethod
    def forward(ctx, x, plan, axis, dim, label):
        from repro_torch.dist import collectives as coll

        ctx.plan, ctx.axis, ctx.dim, ctx.label = plan, axis, dim % x.dim(), label
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return tuple(coll.exchange(x, plan, axis.name, mesh=axis.mesh, dim=dim, label=label))

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.dist import collectives as coll

        back, lands = coll.transposed(ctx.plan)
        got = coll.exchange(torch.cat(grads, ctx.dim), back, ctx.axis.name, mesh=ctx.axis.mesh,
                            dim=ctx.dim, label=ctx.label and f"{ctx.label}_grad")
        g = torch.zeros(ctx.shape, dtype=ctx.dtype, device=grads[0].device)
        for piece, (start, length) in zip(got, lands[ctx.axis.rank]):
            g.narrow(ctx.dim, start, length).add_(piece)
        return g, None, None, None, None


class _Split(torch.autograd.Function):
    """The transpose of ``ModelAxis.cat``: this rank's equal slice of ``dim``
    of a tensor that every rank holds whole, with no collective; backward:
    every rank's gradient slice concatenated on ``dim`` in rank order (an
    all-gather), so that the gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, dim, axis, label):
        ctx.dim, ctx.axis, ctx.label = dim, axis, label
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.rank * n, n)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist import collectives as coll

        axis = ctx.axis
        return (coll.gather_cat(g.contiguous(), axis.name, mesh=axis.mesh, dim=ctx.dim,
                                label=ctx.label), None, None, None)


class ModelAxis:
    """The ``model`` axis of a mesh as the partitioned layers use it:
    ``size`` ranks, this rank at ``rank``; ``enter`` and ``reduce`` are the
    conjugate pair of Megatron's tensor parallelism, ``sum`` the
    rank-ordered all-reduce (``collectives.all_reduce_sum``: the same bits
    on every rank), ``parts`` every rank's tensor stacked in rank order,
    ``exchange`` the pieces of the ranks' tensors that a plan gives this
    rank (``collectives.exchange``; its gradient goes back to the owners),
    ``cat`` every rank's tensor concatenated (its gradient this rank's
    slice) and ``split`` its transpose (this rank's slice of a tensor every
    rank holds whole; its gradient gathered).  No weight is gathered over
    the axis.  ``label`` names a collective in ``collectives.LABELS``."""

    name = "model"

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = mesh_shape(mesh)[self.name]
        self.rank = mesh_coordinate(mesh)[self.name]

    def sum(self, x: torch.Tensor, label: str = None) -> torch.Tensor:
        from repro_torch.dist import collectives as coll

        return coll.all_reduce_sum(x, self.name, mesh=self.mesh, label=label)

    def exchange(self, x: torch.Tensor, plan, dim: int, label: str = None):
        """``collectives.exchange`` of ``x``, differentiable: a tuple of this
        rank's pieces.  Its backward is a collective too, so every rank's
        plan takes at least one piece (a rank with no piece would have no
        backward to join)."""
        return _Exchange.apply(x, plan, self, dim, label)

    def parts(self, x: torch.Tensor) -> torch.Tensor:
        return _Parts.apply(x, self)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self)

    def reduce(self, partial: torch.Tensor, dtype) -> torch.Tensor:
        """The float32 partials' sum over the axis, rounded once to ``dtype``."""
        return _Reduce.apply(partial, self).to(dtype)

    def cat(self, x: torch.Tensor, dim: int, label: str = None) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``dim`` in rank order (serving's
        logits; attention's q, k and v products where the axis cuts inside
        a head, and a decode's output on an ``hd``-cut cache); its gradient
        this rank's slice."""
        return _GatherDim.apply(x, dim % x.dim(), (self.name,), self.mesh, self.rank, label)

    def split(self, x: torch.Tensor, dim: int, label: str = None) -> torch.Tensor:
        """This rank's equal slice of ``dim`` of ``x``, which every rank holds
        whole (``cat``'s transpose): no collective forward; backward the
        gradient gathered over the axis (``label`` names that gather).  Every
        rank calls it, whether or not its slice holds whole heads: the
        backward is a collective."""
        return _Split.apply(x, dim % x.dim(), self, label)


class SequenceAxis:
    """The worker axes of a mesh as a sequence-sharded cache uses them
    (``cache_specs(..., seq_sharded=True)``, ``long_500k``): the attention
    cache's sequence dim cut into ``size`` equal parts over ``axes``, this
    rank holding the part at its coordinates on them flattened major to
    minor (``shard_slices``); ``rows(S)`` is its global rows ``[r0, r1)``
    of a cache of ``S`` rows, ``parts`` every rank's tensor stacked in
    group-rank order (``collectives.reduce_parts``)."""

    def __init__(self, mesh):
        self.mesh, self.axes = mesh, worker_axes(mesh)
        if not self.axes:
            raise ValueError("a sequence-sharded cache needs a worker axis on the mesh")
        self.size = n_workers(mesh)

    def rows(self, S: int) -> Tuple[int, int]:
        sl = shard_slices(PartitionSpec(self.axes), (S,), mesh_shape(self.mesh),
                          mesh_coordinate(self.mesh))[0]
        return sl.start, sl.stop

    def parts(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.dist import collectives as coll

        return coll.reduce_parts(x, self.axes, mesh=self.mesh)


def row_partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial on this rank's part of the
    contraction, in float32 (``ModelAxis.reduce`` sums the partials and
    rounds once)."""
    return x.to(torch.float32) @ w.to(torch.float32)


class ShardedParams:
    """What the transformer runs a rank's shards with: the leaves gathered
    over the storage axes just before they are used, the ``model`` cut
    kept, and the ``model`` axis (``ModelAxis``) for every sublayer whose
    leaves it cuts (the module docstring).

    ``layer(lp)`` gathers one layer's leaves (the views ``unbind`` gives of
    the stacked shards; the stacked layer dim is never cut); ``top(name, sub)`` a top-level entry (embed,
    head, final norm); ``axis_for(path)`` is the ``ModelAxis`` when the
    ``model`` axis cuts a leaf under ``path`` (a tuple of dict keys, from
    the layer's root or, with ``top=True``, the tree's), else None.  With
    ``seq_sharded`` the serving caches are cut on their sequence over the
    worker axes too, and ``seq`` is that cut (a ``SequenceAxis``; else
    None)."""

    def __init__(self, specs: Any, mesh, seq_sharded: bool = False):
        self.specs, self.mesh = specs, mesh
        sizes = mesh_shape(mesh)
        self.layer_specs = tree_map(lambda s: PartitionSpec(*s.parts[1:]),
                                    specs.get("layers"))
        self.storage = tuple(a for a in sizes if a != ModelAxis.name)
        self.model = ModelAxis(mesh) if sizes.get(ModelAxis.name, 1) > 1 else None
        self.seq = SequenceAxis(mesh) if seq_sharded else None

    def layer(self, lp: Any) -> Any:
        return {k: gather_tree(v, self.layer_specs[k], self.mesh, self.storage)
                for k, v in lp.items()}

    def top(self, name: str, sub: Any) -> Any:
        return gather_tree(sub, self.specs[name], self.mesh, self.storage)

    def axis_for(self, path: Sequence[str], top: bool = False):
        if self.model is None:
            return None
        sub = self.specs if top else self.layer_specs
        for k in path:
            sub = sub[k]
        cut = any(ModelAxis.name in spec_axes(part) for spec in tree_leaves(sub)
                  for part in spec)
        return self.model if cut else None


class Sharder:
    """This rank's slice of each parameter leaf as it is made.

    ``sharder(names, x)`` takes a leaf's dict path and its whole value and
    returns the rank's part, from ``param_specs``' rule for that path and
    shape; ``stack=L`` marks one layer's slice of a stacked ``(L, ...)``
    leaf (the stacked dim is never cut).  The global shapes are recorded, so
    that ``global_like`` can give the meta tree that ``param_specs`` and the
    steps take."""

    def __init__(self, cfg, mesh):
        self.cfg, self.sizes, self.coord = cfg, mesh_shape(mesh), mesh_coordinate(mesh)
        self.shapes: Dict[Tuple[str, ...], Tuple[int, ...]] = {}

    def __call__(self, names: Tuple[str, ...], x: torch.Tensor, stack: int = 0
                 ) -> torch.Tensor:
        shape = (stack, *x.shape) if stack else tuple(x.shape)
        self.shapes[tuple(names)] = shape
        spec = _leaf_spec(self.cfg, self.sizes, tuple(names), shape)
        sl = shard_slices(spec, shape, self.sizes, self.coord)[1 if stack else 0:]
        if all(s.stop - s.start == n for s, n in zip(sl, x.shape)):
            return x
        return x[sl].clone(memory_format=torch.contiguous_format)

    def global_like(self, shards: Any) -> Any:
        """Meta tensors of the global shapes, in the structure of ``shards``."""
        return map_with_paths(lambda names, x: torch.empty(
            self.shapes[tuple(names)], dtype=x.dtype, device="meta"), shards)
