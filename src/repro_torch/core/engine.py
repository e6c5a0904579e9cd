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
Sharding ``specs`` have no counterpart on one card: only ``specs=None``.
Steps and workers are Python ints; salts are folded on the host.

``vmap_workers`` (``zo_coeffs``, ``reconstruct``) keeps the reference's
semantics without ``torch.func.vmap``: the coefficients are the same
per-worker values either way (eager PyTorch has no program size to keep
O(1) in m), and the batched reconstruction generates the m directions of a
leaf at once and contracts them in one float32 sum, rounded once to
``acc_dtype`` -- equal to the sequential path within accumulation order.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.core import directions as D
from repro_torch.device import host_to_device
from repro_torch.dtypes import acc_dtype_of
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

_F32 = torch.float32


class DirectionEngine:
    """Base class: shared metadata, norm algebra, and the coefficient eval."""

    name = "base"

    def __init__(self, params_like: Any, seed: int, *, specs: Any = None,
                 acc_dtype: Any = "float32", block: int = 4096):
        if specs is not None:
            raise ValueError("sharding specs have no counterpart on one card; "
                             "the port's engines take specs=None only")
        leaves, self.treedef = tree_flatten(params_like)
        self.shapes: List[Tuple[int, ...]] = [tuple(x.shape) for x in leaves]
        self.dtypes = [x.dtype for x in leaves]
        self.sizes = [int(math.prod(s)) for s in self.shapes]
        # per-leaf base index in the flat d-dim vector (layout metadata, NOT a
        # hash counter: counters are leaf-local)
        self.offsets: List[int] = []
        off = 0
        for n in self.sizes:
            self.offsets.append(off)
            off += n
        self.dim = off
        self.seed = seed
        self.acc_dtype = acc_dtype_of(acc_dtype)
        self.block = block
        self.device = leaves[0].device if leaves else torch.device("cpu")

    # ---- metadata ------------------------------------------------------- #
    def salts(self, t, worker) -> List[int]:
        """Per-leaf salts for (t, worker) — the hash identity of one v."""
        return [D.fold(self.seed, t, worker, i) for i in range(len(self.shapes))]

    def _gauss(self, i: int, salt) -> torch.Tensor:
        """Leaf i's raw (unnormalized) float32 direction."""
        return D.gaussian_from_salt(self.shapes[i], salt, device=self.device)

    # ---- primitive 1: the unit-sphere normalization --------------------- #
    def sumsq(self, t, worker) -> torch.Tensor:
        """||v_raw||^2 over the whole tree (the shared reduction)."""
        return sum(torch.sum(torch.square(self._gauss(i, s)))
                   for i, s in enumerate(self.salts(t, worker)))

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

    def _prescaled(self, coeffs, t, workers) -> torch.Tensor:
        """``coeffs[w] * inv_norm_w``: what the kernels take per worker."""
        return coeffs * torch.stack([self.inv_norm(t, w) for w in workers])

    def _reconstruct_vmapped(self, coeffs, t, workers) -> Any:
        scaled = self._prescaled(coeffs, t, workers)
        outs = []
        for i, shape in enumerate(self.shapes):
            idx = torch.arange(self.sizes[i], dtype=torch.int64, device=self.device)
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
        for i, w in enumerate(workers):
            coeff = coeffs[i] * self.inv_norm(t, w)
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
        for i, w in enumerate(workers):
            coeff = coeffs[i] * self.inv_norm(t, w)
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
    (leaves, m) salt table to the card once, without blocking the host.
    """

    name = "pallas"

    def perturb(self, params, t, worker, scale):
        from repro_torch.kernels import ops  # deferred, as in FlatEngine

        out = [ops.zo_perturb(x.reshape(-1), s, scale).reshape(x.shape)
               for x, s in zip(tree_leaves(params), self.salts(t, worker))]
        return tree_unflatten(self.treedef, out)

    def _reconstruct(self, coeffs, t, workers):
        from repro_torch.kernels import ops

        scaled = self._prescaled(coeffs, t, workers)
        table = np.asarray([self.salts(t, w) for w in workers], np.uint32).T
        salts = host_to_device(table, self.device)
        out = [ops.zo_reconstruct(n, salts[li], scaled,
                                  acc_dtype=self.acc_dtype).reshape(shape)
               for li, (n, shape) in enumerate(zip(self.sizes, self.shapes))]
        return tree_unflatten(self.treedef, out)


# --------------------------------------------------------------------------- #
class FlatEngine(DirectionEngine):
    """Packed single-buffer backend: the whole tree in one kernel launch.

    Every leaf is padded to whole blocks of ``block`` floats, so each block
    belongs to one leaf; per-block ``(leaf, counter start, valid lanes,
    is-bf16)`` metadata is built once.  The hash identity is unchanged
    (leaf-local counters from 0, one salt per (t, worker, leaf)).

    The fused step path keeps the buffer packed across the ZO round.
    ``fused_reconstruct_update`` writes IN PLACE into the buffers it is
    given (the counterpart of the JAX kernel's ``input_output_aliases``), so
    they must be engine-owned: ``pack`` returns a fresh copy every call, and
    no tree a caller holds aliases a buffer before it is committed.
    """

    name = "flat"

    def __init__(self, params_like: Any, seed: int, *, specs: Any = None,
                 acc_dtype: Any = "float32", block: int = 4096):
        super().__init__(params_like, seed, specs=specs, acc_dtype=acc_dtype,
                         block=block)
        blk_leaf, blk_ctr, blk_nv = [], [], []
        self.pad_offsets: List[int] = []   # leaf start in the PACKED buffer
        off = 0
        for i, n in enumerate(self.sizes):
            self.pad_offsets.append(off)
            nb = max(1, -(-n // block))    # scalars still occupy one block
            for b in range(nb):
                blk_leaf.append(i)
                blk_ctr.append(b * block)
                blk_nv.append(min(block, n - b * block))
            off += nb * block
        self.padded_dim = off
        self.n_blocks = len(blk_leaf)
        self._blk_leaf = np.asarray(blk_leaf, np.int64)
        dev = self.device
        self._blk_ctr = torch.from_numpy(np.asarray(blk_ctr, np.uint32)).to(dev)
        self._blk_nv = torch.tensor(blk_nv, dtype=torch.int32, device=dev)
        self._blk_bf16 = torch.tensor(
            [1 if self.dtypes[i] == torch.bfloat16 else 0 for i in blk_leaf],
            dtype=torch.int32, device=dev)

    # ---- packed-buffer layout ------------------------------------------- #
    def pack(self, tree: Any) -> torch.Tensor:
        """Tree -> fresh (padded_dim,) contiguous float32 buffer."""
        parts = []
        for i, x in enumerate(tree_leaves(tree)):
            flat = x.to(_F32).reshape(-1)
            pad = -(-max(self.sizes[i], 1) // self.block) * self.block \
                - self.sizes[i]
            parts.append(torch.nn.functional.pad(flat, (0, pad)) if pad else flat)
        return torch.cat(parts)

    def unpack(self, buf: torch.Tensor, cast: bool = True) -> Any:
        """(padded_dim,) buffer -> tree of views; ``cast`` restores leaf
        dtypes (False keeps float32 leaves — update/momentum trees)."""
        outs = []
        for i, shape in enumerate(self.shapes):
            off = self.pad_offsets[i]
            leaf = buf[off:off + self.sizes[i]].reshape(shape)
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
    def fused_perturb_sumsq(self, buf: torch.Tensor, t, worker, mu
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(buf + mu*rsqrt(sumsq)*v, sumsq)``: the norm pass over d folds
        into the perturb."""
        from repro_torch.kernels import ops

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
                acc_dtype: Any = "float32", block: int = 4096
                ) -> DirectionEngine:
    """Build a DirectionEngine backend by name
    ('tree' | 'fused' | 'pallas' | 'flat')."""
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown direction engine {name!r}; have {sorted(ENGINES)}"
        ) from None
    return cls(params_like, seed, specs=specs, acc_dtype=acc_dtype, block=block)
