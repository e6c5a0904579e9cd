"""DirectionEngine: the one home of the ZO direction algebra, in PyTorch.

Counterpart of ``repro.core.engine``.  Four primitives over the flattened
parameter tree: the direction norm (``sumsq``/``inv_norm``), ``perturb``,
the scalar coefficient ``zo_coeff(s)`` and ``reconstruct``.

Backends
--------
* ``tree``  — the readable reference: materializes every leaf's direction
              per primitive.
* ``fused`` — generates one leaf's direction at a time inside the consuming
              op (in eager PyTorch the same arithmetic as ``tree``, with one
              leaf's direction alive at a time instead of the whole tree's).
* ``pallas`` — routes ``perturb``/``reconstruct`` through the per-leaf
              CUDA kernels (``kernels.ops.zo_perturb``/``zo_reconstruct``;
              the plain versions on a CPU tensor): one launch per leaf, the
              direction regenerated in registers, all m workers
              reconstructed in one pass over each leaf.
* ``flat``  — packs the tree into ONE contiguous block-aligned float32 buffer
              and runs one hand-written CUDA kernel per primitive
              (``repro_torch.kernels.ops``; the plain versions on a CPU
              tensor), plus the fused step path used by ``core.ho_sgd`` with
              plain SGD(+momentum): perturb + norm in one call, reconstruct +
              commit in one in-place launch.

Contract (README §DirectionEngine of the JAX package): leaf i of worker w at
step t uses salt ``fold(seed, t, w, i)`` with leaf-local counters from 0, in
sorted-key leaf order; ``inv_norm`` is the shared reduction in every backend;
``perturb`` applies ``x_f32 + scale * v`` cast back to the leaf dtype;
``reconstruct`` rounds the accumulator to ``acc_dtype`` after every worker.
Steps and workers are Python ints; salts are folded on the host.

Sharded placements: ``specs`` (a spec tree or list, ``dist.sharding``) with
the ``mesh`` make an engine over this rank's shards (``params_like`` holds
shards).  An element's counter stays its row-major index in the GLOBAL leaf,
mod 2**32, so a shard's direction is bit for bit the slice of the whole
leaf's; ``dim`` is the global d; the norm is global (each leaf's partial
over the rank's shard, all-gathered over the shard axes and summed in one
fixed order, ``ShardGeometry.reduce_sums``, booked ``payload=False``).
``tree``/``fused`` generate a shard from its counters; ``flat`` packs the
shard as runs of consecutive global counters, each run cut into blocks of a
size picked from the runs (``shard_block``), so the flat kernels run on it
unchanged; ``pallas`` hands its per-leaf kernels each sharded leaf's run
table (every run's first global counter, ``ShardGeometry.runs``, built on
the card once when the engine is made), one launch per leaf and primitive
whatever the placement (a column-parallel shard has a run per row).
The flat engine's fused pair (``fused_*``) scales by its own buffer's norm
and raises under sharded specs.  ``specs`` without a mesh raise; specs that
cut no leaf over an axis of more than one rank leave the engine as it is
without them.

``vmap_workers`` (``zo_coeffs``, ``reconstruct``) keeps the reference's
semantics without ``torch.func.vmap``: the coefficients are the same
per-worker values either way (eager PyTorch has no program size to keep
O(1) in m), and the batched reconstruction generates the m directions of a
leaf at once and contracts them in one float32 sum, rounded once to
``acc_dtype`` -- equal to the sequential path within accumulation order.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import directions as D
from repro_torch.device import host_to_device
from repro_torch.dist.sharding import ShardGeometry
from repro_torch.dtypes import acc_dtype_of
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

_F32 = torch.float32
#: the smallest block the flat engine cuts a shard's runs into
MIN_SHARD_BLOCK = 64


def shard_block(runs: Sequence[Tuple[np.ndarray, int]], block: int = 4096,
                slack: float = 1 / 64) -> int:
    """The flat block for a sharded layout: the largest power of two from
    ``block`` down to ``MIN_SHARD_BLOCK`` whose packed buffer (every run
    padded to whole blocks) is within ``slack`` of the shard's size.  A
    column-parallel shard has short runs (512 values per row of gemma2-2b's
    ``wk`` at model=2), which blocks of 4096 would pad eightfold."""
    size = sum(len(st) * n for st, n in runs)
    b = block
    while b > MIN_SHARD_BLOCK:
        packed = sum(len(st) * max(1, -(-n // b)) * b for st, n in runs)
        if packed <= (1 + slack) * size:
            break
        b //= 2
    return b


class DirectionEngine:
    """Base class: shared metadata, norm algebra, and the coefficient eval."""

    name = "base"

    def __init__(self, params_like: Any, seed: int, *, specs: Any = None, mesh=None,
                 acc_dtype: Any = "float32", block: int = 4096):
        leaves, self.treedef = tree_flatten(params_like)
        # this rank's shapes: the shards' under sharded specs, else the leaves'
        self.shapes: List[Tuple[int, ...]] = [tuple(x.shape) for x in leaves]
        self.dtypes = [x.dtype for x in leaves]
        self.sizes = [int(math.prod(s)) for s in self.shapes]
        # per-leaf base index in the flat vector of this rank's values (layout
        # metadata, NOT a hash counter: counters are leaf-local)
        self.offsets: List[int] = []
        off = 0
        for n in self.sizes:
            self.offsets.append(off)
            off += n
        self.dim = off
        self.geometry: Optional[ShardGeometry] = None
        if specs is not None:
            if mesh is None:
                raise ValueError("sharding specs need the mesh they place leaves on "
                                 "(make_engine(..., specs=, mesh=))")
            geom = ShardGeometry.from_local(specs, params_like, mesh)
            if geom.sharded:
                self.geometry, self.dim = geom, geom.dim
        self.seed = seed
        self.acc_dtype = acc_dtype_of(acc_dtype)
        self.block = block
        self.device = leaves[0].device if leaves else torch.device("cpu")

    # ---- metadata ------------------------------------------------------- #
    def salts(self, t, worker) -> List[int]:
        """Per-leaf salts for (t, worker) — the hash identity of one v."""
        return [D.fold(self.seed, t, worker, i) for i in range(len(self.shapes))]

    def _sharded(self, i: int) -> bool:
        return self.geometry is not None and bool(self.geometry.axes[i])

    def _gauss(self, i: int, salt) -> torch.Tensor:
        """Leaf i's raw (unnormalized) float32 direction (this rank's shard)."""
        if self._sharded(i):
            return D.gaussian_from_counters(self.geometry.counters(i, self.device), salt)
        return D.gaussian_from_salt(self.shapes[i], salt, device=self.device)

    # ---- primitive 1: the unit-sphere normalization --------------------- #
    def sumsq(self, t, worker) -> torch.Tensor:
        """||v_raw||^2 over the whole tree (the shared reduction)."""
        if self.geometry is not None:
            return self.sumsq_many(t, [worker])[0]
        return sum(torch.sum(torch.square(self._gauss(i, s)))
                   for i, s in enumerate(self.salts(t, worker)))

    def sumsq_many(self, t, workers) -> torch.Tensor:
        """``(m,)`` global ||v_raw||^2 of each worker under sharded specs: the
        shards' per-leaf partials reduced in one collective
        (``ShardGeometry.reduce_sums``)."""
        partials = torch.stack([
            torch.stack([torch.sum(torch.square(self._gauss(i, s)))
                         for i, s in enumerate(self.salts(t, w))])
            for w in workers])
        return self.geometry.reduce_sums(partials)

    def inv_norm(self, t, worker) -> torch.Tensor:
        return torch.rsqrt(self.sumsq(t, worker) + 1e-30)

    # ---- primitive 2: perturb ------------------------------------------- #
    def perturb(self, params: Any, t, worker, scale) -> Any:
        """x + scale * v_raw per leaf, cast back to each leaf's dtype;
        ``scale`` is the premultiplied float32 ``mu * inv_norm(t, worker)``."""
        raise NotImplementedError

    # ---- primitive 3: the scalar ZO coefficient (eq. 4) ----------------- #
    def zo_coeff(self, loss_fn: Callable, params: Any, batch: Any, t, worker,
                 mu: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two function evaluations -> (c, f0), c = (d/mu)*[F(x+mu*v) - F(x)]."""
        inv = self.inv_norm(t, worker)
        f0 = loss_fn(params, batch)
        f1 = loss_fn(self.perturb(params, t, worker, mu * inv), batch)
        return ((self.dim / mu) * (f1 - f0)).to(_F32), f0

    def zo_coeffs(self, loss_fn: Callable, params: Any, batches: Any, t,
                  workers, mu: float, *, vmap_workers: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All workers' coefficients; ``batches`` is worker-stacked (m, B, ...).
        ``vmap_workers`` is accepted for the reference's signature: the
        per-worker loop computes the same values."""
        cs, f0s = [], []
        for i, w in enumerate(workers):
            b_i = tree_map(lambda x: x[i], batches)
            c, f0 = self.zo_coeff(loss_fn, params, b_i, t, w, mu)
            cs.append(c)
            f0s.append(f0)
        return torch.stack(cs), torch.stack(f0s)

    # ---- primitive 4: reconstruct --------------------------------------- #
    def reconstruct(self, coeffs: torch.Tensor, t, workers=None, *,
                    vmap_workers: bool = False) -> Any:
        """sum_w (coeffs[w] * inv_norm_w) * v_raw_w as a float32 tree, the
        accumulator rounded to ``acc_dtype`` after every worker; with
        ``vmap_workers`` one float32 contraction over the m directions of
        each leaf, rounded once (equal within accumulation order)."""
        m = int(coeffs.shape[0])
        workers = list(range(m)) if workers is None else [int(w) for w in workers]
        coeffs = coeffs.to(device=self.device, dtype=_F32)
        if vmap_workers:
            return self._reconstruct_vmapped(coeffs, t, workers)
        return self._reconstruct(coeffs, t, workers)

    def _reconstruct(self, coeffs, t, workers) -> Any:
        raise NotImplementedError

    def _inv_norms(self, t, workers) -> torch.Tensor:
        """``(m,)`` inv_norm of each worker (one collective when sharded)."""
        if self.geometry is not None:
            return torch.rsqrt(self.sumsq_many(t, workers) + 1e-30)
        return torch.stack([self.inv_norm(t, w) for w in workers])

    def _prescaled(self, coeffs, t, workers) -> torch.Tensor:
        """``coeffs[w] * inv_norm_w``: what the kernels take per worker."""
        return coeffs * self._inv_norms(t, workers)

    def _reconstruct_vmapped(self, coeffs, t, workers) -> Any:
        scaled = self._prescaled(coeffs, t, workers)
        outs = []
        for i, shape in enumerate(self.shapes):
            idx = (self.geometry.counters(i, self.device).reshape(-1) if self._sharded(i)
                   else torch.arange(self.sizes[i], dtype=torch.int64, device=self.device))
            salts = torch.tensor([D.fold(self.seed, t, w, i) for w in workers],
                                 dtype=torch.int64, device=self.device)
            g = D.gaussian_from_counters(idx[None, :], salts[:, None])   # (m, n)
            acc = torch.tensordot(scaled, g, dims=([0], [0]))            # fp32
            outs.append(acc.to(self.acc_dtype).to(_F32).reshape(shape))
        return tree_unflatten(self.treedef, outs)

    def _acc_init(self) -> List[torch.Tensor]:
        return [torch.zeros(s, dtype=self.acc_dtype, device=self.device)
                for s in self.shapes]


# --------------------------------------------------------------------------- #
class TreeEngine(DirectionEngine):
    """Materialized-tree reference (the historical core.zo_grad path)."""

    name = "tree"

    def perturb(self, params, t, worker, scale):
        leaves = tree_leaves(params)
        vs = [self._gauss(i, s) for i, s in enumerate(self.salts(t, worker))]
        out = [(x.to(_F32) + scale * g).to(x.dtype) for x, g in zip(leaves, vs)]
        return tree_unflatten(self.treedef, out)

    def _reconstruct(self, coeffs, t, workers):
        acc = self._acc_init()
        scaled = self._prescaled(coeffs, t, workers)
        for i, w in enumerate(workers):
            coeff = scaled[i]
            vs = [self._gauss(li, s) for li, s in enumerate(self.salts(t, w))]
            acc = [(a.to(_F32) + coeff * g).to(self.acc_dtype)
                   for a, g in zip(acc, vs)]
        return tree_unflatten(self.treedef, [a.to(_F32) for a in acc])


# --------------------------------------------------------------------------- #
class FusedEngine(DirectionEngine):
    """One leaf's direction alive at a time, generated inside its consumer."""

    name = "fused"

    def perturb(self, params, t, worker, scale):
        leaves = tree_leaves(params)
        out = [(x.to(_F32) + scale * self._gauss(i, s)).to(x.dtype)
               for i, (x, s) in enumerate(zip(leaves, self.salts(t, worker)))]
        return tree_unflatten(self.treedef, out)

    def _reconstruct(self, coeffs, t, workers):
        acc = self._acc_init()
        scaled = self._prescaled(coeffs, t, workers)
        for i, w in enumerate(workers):
            coeff = scaled[i]
            for li, s in enumerate(self.salts(t, w)):
                acc[li] = (acc[li].to(_F32)
                           + coeff * self._gauss(li, s)).to(self.acc_dtype)
        return tree_unflatten(self.treedef, [a.to(_F32) for a in acc])


# --------------------------------------------------------------------------- #
class PallasEngine(DirectionEngine):
    """Per-leaf kernel backend: the direction never touches device memory.

    ``perturb`` is one read + one write of each leaf (``ops.zo_perturb``,
    one launch per leaf); ``reconstruct`` is one pass over each leaf with all
    m Gaussians generated in registers (``ops.zo_reconstruct``, one launch
    per leaf) from the coefficients pre-scaled by ``inv_norm``, which stays
    the shared plain reduction.  The salts are folded on the host: a
    perturb passes its leaf's salt by value, and a reconstruct copies its
    (leaves, m) salt table to the card once, without blocking the host.  A
    sharded leaf's counters go as its run table (``starts``), on the card
    from the engine's construction on.
    """

    name = "pallas"

    def __init__(self, params_like: Any, seed: int, **kw):
        super().__init__(params_like, seed, **kw)
        # a sharded leaf's run table: its runs' first global counters (mod
        # 2**32) on the card, made once; a whole leaf runs from counter 0
        self.starts: List[Optional[torch.Tensor]] = [
            host_to_device((self.geometry.runs(i)[0] & D.MASK).astype(np.uint32), self.device)
            if self._sharded(i) else None for i in range(len(self.shapes))]

    def perturb(self, params, t, worker, scale):
        from repro_torch.kernels import ops  # deferred, as in FlatEngine

        out = [ops.zo_perturb(x.reshape(-1), s, scale, starts=st).reshape(x.shape)
               for x, s, st in zip(tree_leaves(params), self.salts(t, worker), self.starts)]
        return tree_unflatten(self.treedef, out)

    def _reconstruct(self, coeffs, t, workers):
        from repro_torch.kernels import ops

        scaled = self._prescaled(coeffs, t, workers)
        table = np.asarray([self.salts(t, w) for w in workers], np.uint32).T
        salts = host_to_device(table, self.device)
        out = [ops.zo_reconstruct(n, salts[li], scaled, acc_dtype=self.acc_dtype,
                                  starts=st).reshape(shape)
               for li, (n, shape, st) in enumerate(zip(self.sizes, self.shapes, self.starts))]
        return tree_unflatten(self.treedef, out)


def flat_layout(leaf_runs: Sequence[Tuple[np.ndarray, int]], block: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(leaf, counter start, valid lanes)`` of every block of a packed
    buffer (int64, uint32, int32): leaf i's runs in order, each run padded
    to whole blocks (a scalar still occupies one), a block's counter its
    first element's global index mod 2**32."""
    blk_leaf, blk_ctr, blk_nv = [], [], []
    for i, (starts, n) in enumerate(leaf_runs):
        nb = max(1, -(-n // block))
        lanes = np.arange(nb, dtype=np.int64) * block
        blk_leaf.append(np.full(len(starts) * nb, i, np.int64))
        blk_ctr.append(((starts[:, None] + lanes[None, :]) & D.MASK).reshape(-1))
        blk_nv.append(np.tile(np.minimum(block, n - lanes), len(starts)))
    return (np.concatenate(blk_leaf), np.concatenate(blk_ctr).astype(np.uint32),
            np.concatenate(blk_nv).astype(np.int32))


# --------------------------------------------------------------------------- #
class FlatEngine(DirectionEngine):
    """Packed single-buffer backend: the whole tree in one kernel launch.

    Every leaf is padded to whole blocks of ``block`` floats, so each block
    belongs to one leaf; per-block ``(leaf, counter start, valid lanes,
    is-bf16)`` metadata is built once.  The hash identity is unchanged
    (leaf-local counters from 0, one salt per (t, worker, leaf)).  Under
    sharded specs a leaf's shard is its runs of consecutive global counters
    (``ShardGeometry.runs``), each padded to whole blocks, and the block is
    picked from the runs (``shard_block``); ``packed_over_shard`` is the
    packed buffer's size over the shard's.

    The fused step path keeps the buffer packed across the ZO round.
    ``fused_reconstruct_update`` writes IN PLACE into the buffers it is
    given (the counterpart of the JAX kernel's ``input_output_aliases``), so
    they must be engine-owned: ``pack`` returns a fresh copy every call, and
    no tree a caller holds aliases a buffer before it is committed.
    """

    name = "flat"

    def __init__(self, params_like: Any, seed: int, *, specs: Any = None, mesh=None,
                 acc_dtype: Any = "float32", block: int = 4096):
        super().__init__(params_like, seed, specs=specs, mesh=mesh, acc_dtype=acc_dtype,
                         block=block)
        # each leaf as (run starts, run length); a whole leaf is one run from 0
        leaf_runs = [self.geometry.runs(i) if self._sharded(i)
                     else (np.zeros(1, np.int64), n) for i, n in enumerate(self.sizes)]
        if self.geometry is not None:
            self.block = block = shard_block(leaf_runs, block)
        self._blk_leaf, blk_ctr, blk_nv = flat_layout(leaf_runs, block)
        self.pad_offsets: List[int] = []   # leaf start in the PACKED buffer
        self._row = []                     # per leaf: (runs, run length, padded run)
        off = 0
        for starts, n in leaf_runs:
            self.pad_offsets.append(off)
            padded = max(1, -(-n // block)) * block
            self._row.append((len(starts), n, padded))
            off += len(starts) * padded
        self.padded_dim = off
        self.packed_over_shard = off / max(1, sum(self.sizes))
        self.n_blocks = len(self._blk_leaf)
        dev = self.device
        self._blk_ctr = torch.from_numpy(blk_ctr).to(dev)
        self._blk_nv = torch.from_numpy(blk_nv).to(dev)
        bf16 = np.asarray([self.dtypes[i] == torch.bfloat16 for i in range(len(self.sizes))],
                          np.int32)
        self._blk_bf16 = torch.from_numpy(bf16[self._blk_leaf]).to(dev)

    # ---- packed-buffer layout ------------------------------------------- #
    def pack(self, tree: Any) -> torch.Tensor:
        """Tree -> fresh (padded_dim,) contiguous float32 buffer."""
        parts = []
        for i, x in enumerate(tree_leaves(tree)):
            runs, n, padded = self._row[i]
            flat = x.to(_F32).reshape(runs, -1)
            pad = padded - flat.shape[1]
            parts.append((torch.nn.functional.pad(flat, (0, pad)) if pad else flat)
                         .reshape(-1))
        return torch.cat(parts)

    def unpack(self, buf: torch.Tensor, cast: bool = True) -> Any:
        """(padded_dim,) buffer -> tree of views; ``cast`` restores leaf
        dtypes (False keeps float32 leaves — update/momentum trees)."""
        outs = []
        for i, shape in enumerate(self.shapes):
            off = self.pad_offsets[i]
            runs, n, padded = self._row[i]
            if runs == 1:
                leaf = buf[off:off + self.sizes[i]].reshape(shape)
            else:
                leaf = buf[off:off + runs * padded].view(runs, padded)[:, :n].reshape(shape)
            outs.append(leaf.to(self.dtypes[i]) if cast else leaf)
        return tree_unflatten(self.treedef, outs)

    def blk_salts(self, t, worker) -> torch.Tensor:
        """(n_blocks,) uint32 — each block's leaf salt for (t, worker)."""
        s = np.asarray(self.salts(t, worker), np.uint32)[self._blk_leaf]
        return torch.from_numpy(s).to(self.device)

    def blk_salts_multi(self, t, workers) -> torch.Tensor:
        """(n_blocks, m) uint32 — per-(block, worker) salts."""
        s = np.stack([np.asarray(self.salts(t, int(w)), np.uint32)[self._blk_leaf]
                      for w in workers], axis=1)
        return torch.from_numpy(np.ascontiguousarray(s)).to(self.device)

    # ---- standard primitives (pack -> one launch -> unpack) -------------- #
    def perturb(self, params, t, worker, scale):
        # deferred (here and below): kernels.ref imports core.directions,
        # and importing the core package imports this module
        from repro_torch.kernels import ops

        out = ops.zo_perturb_flat(
            self.pack(params), self.blk_salts(t, worker), self._blk_ctr,
            self._blk_nv, scale, block=self.block)
        return self.unpack(out)

    def _reconstruct(self, coeffs, t, workers):
        from repro_torch.kernels import ops

        out = ops.zo_reconstruct_flat(
            self.blk_salts_multi(t, workers), self._prescaled(coeffs, t, workers),
            self._blk_ctr, self._blk_nv, block=self.block, acc_dtype=self.acc_dtype)
        return self.unpack(out, cast=False)

    # ---- fused step path (buffer stays packed across the round) ---------- #
    def _unsharded(self, what: str) -> None:
        if self.geometry is not None:
            raise ValueError(f"{what} scales by its own buffer's norm, and under sharded "
                             "specs the norm is global: use perturb/reconstruct")

    def fused_perturb_sumsq(self, buf: torch.Tensor, t, worker, mu
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(buf + mu*rsqrt(sumsq)*v, sumsq)``: the norm pass over d folds
        into the perturb."""
        from repro_torch.kernels import ops

        self._unsharded("fused_perturb_sumsq")

        out, ss = ops.zo_perturb_sumsq(
            buf, self.blk_salts(t, worker), self._blk_ctr, self._blk_nv, mu,
            block=self.block)
        return out, ss[0]

    def fused_reconstruct_update(self, buf: torch.Tensor, mom, t, workers,
                                 scaled_coeffs: torch.Tensor, lr,
                                 momentum: float = 0.0):
        """One launch: regenerate all m directions, contract with
        ``scaled_coeffs`` (= c_w * inv_norm_w * zo_scale / m) and commit the
        SGD(+momentum) update in place.  Returns ``(buf, mom)``."""
        from repro_torch.kernels import ops

        self._unsharded("fused_reconstruct_update")

        return ops.zo_reconstruct_update(
            buf, mom, self.blk_salts_multi(t, workers), self._blk_ctr,
            self._blk_nv, self._blk_bf16, scaled_coeffs.to(_F32).contiguous(),
            lr, momentum=float(momentum), block=self.block,
            acc_dtype=self.acc_dtype)


# --------------------------------------------------------------------------- #
ENGINES = {
    "tree": TreeEngine,
    "fused": FusedEngine,
    "pallas": PallasEngine,
    "flat": FlatEngine,
}


def make_engine(name: str, params_like: Any, seed: int, *, specs: Any = None,
                mesh=None, acc_dtype: Any = "float32", block: int = 4096
                ) -> DirectionEngine:
    """Build a DirectionEngine backend by name
    ('tree' | 'fused' | 'pallas' | 'flat'); ``specs`` with the ``mesh``
    make it an engine over this rank's shards (the module docstring)."""
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown direction engine {name!r}; have {sorted(ENGINES)}"
        ) from None
    return cls(params_like, seed, specs=specs, mesh=mesh, acc_dtype=acc_dtype,
               block=block)
