"""The byte ledger of collectives, in PyTorch.

Counterpart of ``repro.dist.collectives``.  The paper's headline claim is a
communication load: (tau-1+d)/tau scalars per worker per iteration for
HO-SGD against d for sync-SGD (Table 1).  The ``CommLedger`` measures it:
every collective booked through this module records its payload bytes per
worker, and the ledger accumulates them per host-level step call.

How it composes with eager PyTorch: ``ledger.wrap(name, fn)`` returns a
callable that marks the ledger active while ``fn`` runs, so every booking
made during the call registers as that program's records, and bumps the
step counter.  The reference registers records once per jit trace; here
every call records, and a call that records something replaces the
program's records -- the same ``bytes_per_step``, ``total_bytes`` and
``summary`` as the reference whenever a program books the same bytes on
every call, which the round programs do.

Accounting semantics (the reference's contract):
  * ``all_gather``: bytes of the gathered result per worker -- m scalars
    gathered over m workers is ``4*m`` bytes, independent of d.
  * ``psum``/``pmean`` and ``note_all_reduce``: bytes of the reduced payload
    per worker -- a d-dim fp32 gradient all-reduce is ``4*d`` bytes.
  * ``payload=False`` marks diagnostics (e.g. averaging the monitoring loss)
    that are not part of the algorithm's communication; they appear in the
    per-kind breakdown but are excluded from ``bytes_per_step``.

``all_gather``, ``psum`` and ``pmean`` run over a ``torch.distributed``
process group: ``axes`` names dimensions of ``mesh`` (a ``DeviceMesh``,
``launch.mesh``), and the call runs over the group of the ranks that share
this rank's coordinates on every other dimension.  ``note`` and
``note_all_reduce`` book an exchange without performing one, which is how a
process that holds all m workers (the round executor, the single-process
lowering) books its collectives.  A step over sharded parameters books its
exchange at the global tree's bytes (``pmean``'s ``nbytes``), as the
reference's traced global shapes do; ``gather_cat``, the sharded
placements' storage collective (``dist.sharding.gather``), books nothing.
Ranks that share one card (gloo ranks on ``cuda:0``) run ``gather_cat``
device to device through CUDA IPC handles rather than through host memory.

``GATHERS`` counts ``gather_cat``'s calls and the bytes of its results per
tuple of axes (``reset_gathers`` sets them to 0): the dry run's gathered
bytes (``launch.dryrun``).  Every collective that runs over the group
(``gather_cat``, ``all_gather``, ``psum``, ``pmean``) is one
``record_function`` span named ``collective:<kind>`` (``all-gather`` or
``all-reduce``), which ``launch.overlap`` pairs with the kernels a profiler
trace shows between its ends.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Axes = Union[str, Sequence[str]]

_ACTIVE: List[Tuple["CommLedger", str]] = []

#: axes -> [calls, bytes of the gathered results] of ``gather_cat``
GATHERS: Dict[Tuple[str, ...], List[int]] = {}


def reset_gathers() -> None:
    GATHERS.clear()


def _span(kind: str):
    """The profiler span of one collective (``launch.overlap``)."""
    return torch.profiler.record_function(f"collective:{kind}")


@dataclass
class _Record:
    kind: str
    tag: str
    nbytes: int
    payload: bool


@dataclass
class CommLedger:
    """Host-side per-program byte accounting for collectives."""

    programs: Dict[str, List[_Record]] = field(default_factory=dict)
    steps: Dict[str, int] = field(default_factory=dict)
    _recording: Optional[List[_Record]] = None

    # --- registration --------------------------------------------------------
    def record(self, kind: str, nbytes: int, *, tag: str = "",
               payload: bool = True) -> None:
        if self._recording is not None:
            self._recording.append(_Record(kind, tag, int(nbytes), payload))

    # --- program wrapping ----------------------------------------------------
    def wrap(self, name: str, fn):
        """Instrument a step callable: its bookings register under ``name``."""
        def wrapped(*args, **kwargs):
            self._recording, saved = [], self._recording
            _ACTIVE.append((self, name))
            try:
                out = fn(*args, **kwargs)
            finally:
                _ACTIVE.pop()
                recorded, self._recording = self._recording, saved
            if recorded:
                self.programs[name] = recorded
            self.steps[name] = self.steps.get(name, 0) + 1
            return out
        return wrapped

    # --- queries --------------------------------------------------------------
    def bytes_per_step(self, name: str, payload_only: bool = True) -> int:
        return sum(r.nbytes for r in self.programs.get(name, [])
                   if r.payload or not payload_only)

    def total_bytes(self, payload_only: bool = True) -> int:
        return sum(self.bytes_per_step(n, payload_only) * s
                   for n, s in self.steps.items())

    def by_kind(self, name: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.programs.get(name, []):
            key = f"{r.kind}:{r.tag}" if r.tag else r.kind
            out[key] = out.get(key, 0) + r.nbytes
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            name: {
                "steps": self.steps.get(name, 0),
                "bytes_per_step": self.bytes_per_step(name),
                "bytes_total": self.bytes_per_step(name) * self.steps.get(name, 0),
                "by_kind": self.by_kind(name),
            }
            for name in sorted(set(self.programs) | set(self.steps))
        }

    def reset(self) -> None:
        self.steps.clear()


def _record_active(kind: str, nbytes: int, tag: str, payload: bool) -> None:
    if _ACTIVE:
        _ACTIVE[-1][0].record(kind, nbytes, tag=tag, payload=payload)


def _tree_nbytes(tree: Any) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


# --------------------------------------------------------------------------- #
# collectives over a process group
# --------------------------------------------------------------------------- #
#: groups of several mesh axes, per mesh, made at their first use
_AXES_GROUPS: "weakref.WeakKeyDictionary[Any, Dict[Tuple[str, ...], Any]]" = \
    weakref.WeakKeyDictionary()


def axes_group(mesh, axes: Axes):
    """The process group over ``axes`` of ``mesh`` that holds this rank.

    One axis is the mesh's own group for that dimension.  Several axes are
    flattened in the order given (``("pod", "data")``: rank order ``pod_idx *
    n_data + data_idx``, the worker ids); their groups are made at the first
    call, on every rank of the mesh -- a collective call, as the collective
    that asks for them is -- and kept for the mesh's lifetime."""
    import torch.distributed as dist

    if mesh is None or not dist.is_initialized():
        raise RuntimeError("a collective over mesh axes needs an initialised "
                           "torch.distributed process group and a DeviceMesh over it")
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    dims = [mesh.mesh_dim_names.index(a) for a in names]
    if len(dims) == 1:
        return mesh.get_group(names[0])
    groups = _AXES_GROUPS.setdefault(mesh, {})
    if names not in groups:
        rest = [d for d in range(mesh.ndim) if d not in dims]
        size = math.prod(mesh.mesh.shape[d] for d in dims)
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, size)
        groups[names], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return groups[names]


def _staged(x: torch.Tensor, group) -> Tuple[torch.Tensor, bool]:
    """``x`` as the group's backend takes it: gloo has no CUDA path for
    every collective, so on a gloo group a CUDA payload is staged through
    host memory, always (one rule for every collective); NCCL takes it as
    it is.  Returns (the tensor to send, whether it was staged)."""
    import torch.distributed as dist

    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu(), True
    return x, False


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in a new tensor on ``x``'s device."""
    import torch.distributed as dist

    y, staged = _staged(x.contiguous(), group)
    y = y if staged else y.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device) if staged else y


class _CardExchange:
    """``gather_cat`` between ranks that share one CUDA device: each rank
    copies its part into a buffer of its own that every rank of the group
    has opened through a CUDA IPC handle, and every rank reads the parts
    device to device.  A barrier after the writes and one after the reads
    (each behind a stream synchronize) keep a rank from reading a part
    before it is written, or overwriting its buffer before it is read.  The
    buffers grow in step on every rank: the ranks of a group gather the same
    shapes in the same order."""

    def __init__(self, group, device):
        self.group, self.device = group, device
        self.mine: Optional[torch.Tensor] = None
        self.parts: List[torch.Tensor] = []

    def _grow(self, nbytes: int) -> None:
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor

        self.parts = []
        self.mine = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        handles: List[Any] = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(handles, reduce_tensor(self.mine), group=self.group)
        me = dist.get_rank(self.group)
        self.parts = [self.mine if r == me else rebuild(*args)
                      for r, (rebuild, args) in enumerate(handles)]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        n = x.numel() * x.element_size()
        if self.mine is None or self.mine.numel() < n:
            self._grow(max(n, 0 if self.mine is None else 2 * self.mine.numel()))
        stream = torch.cuda.current_stream(self.device)
        self.mine[:n].copy_(x.reshape(-1).view(torch.uint8))
        stream.synchronize()
        dist.barrier(group=self.group)
        out = torch.cat([p[:n].view(x.dtype).view(x.shape) for p in self.parts], dim)
        stream.synchronize()
        dist.barrier(group=self.group)
        return out


#: per mesh and axes: the ``_CardExchange`` of their group, or None when its
#: ranks are not on one card; its buffers go with the mesh
_CARDS: "weakref.WeakKeyDictionary[Any, Dict[Tuple[str, ...], Optional[_CardExchange]]]" = \
    weakref.WeakKeyDictionary()


def _card_exchange(mesh, axes: Axes, x: torch.Tensor) -> Optional[_CardExchange]:
    """The same-card exchange over ``axes`` of ``mesh``, decided at their
    first CUDA gather (a collective call): every rank of the group on one
    host and one device (by the device's UUID)."""
    import socket

    import torch.distributed as dist

    names = (axes,) if isinstance(axes, str) else tuple(axes)
    cards = _CARDS.setdefault(mesh, {})
    if names not in cards:
        group = axes_group(mesh, names)
        uuid = getattr(torch.cuda.get_device_properties(x.device), "uuid", None)
        where: List[Any] = [None] * dist.get_world_size(group)
        dist.all_gather_object(where, (socket.gethostname(), str(uuid)), group=group)
        same = uuid is not None and len(set(where)) == 1
        cards[names] = _CardExchange(group, x.device) if same else None
    return cards[names]


def gather_cat(x: torch.Tensor, axes: Axes, *, mesh, dim: int) -> torch.Tensor:
    """The parts of ``x`` over the ``axes`` of ``mesh``, concatenated on
    ``dim`` in group-rank order, on ``x``'s device; books nothing.  Ranks
    that share one card exchange CUDA parts device to device
    (``_CardExchange``); otherwise the group's backend carries them (gloo
    through host memory)."""
    with _span("all-gather"):
        out = _gather_cat(x, axes, mesh, dim)
    stat = GATHERS.setdefault((axes,) if isinstance(axes, str) else tuple(axes), [0, 0])
    stat[0] += 1
    stat[1] += out.numel() * out.element_size()
    return out


def _gather_cat(x: torch.Tensor, axes: Axes, mesh, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    if x.is_cuda:
        card = _card_exchange(mesh, axes, x)
        if card is not None:
            return card.gather(x, dim)
    group = axes_group(mesh, axes)
    y, staged = _staged(x.contiguous(), group)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if staged else out


def all_gather(x: torch.Tensor, axes: Axes, *, mesh, tiled: bool = False,
               tag: str = "", payload: bool = True) -> torch.Tensor:
    """All-gather ``x`` over the ``axes`` of ``mesh``, stacked on a new
    leading dim in group-rank order (``tiled``: concatenated on dim 0), and
    book the gathered result's bytes: one float32 scalar per worker over m
    workers is ``4*m`` bytes, the ZO step's whole inter-worker traffic."""
    import torch.distributed as dist

    group = axes_group(mesh, axes)
    with _span("all-gather"):
        y, staged = _staged(x.contiguous(), group)
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        out = torch.cat(parts) if tiled else torch.stack(parts)
        out = out.to(x.device) if staged else out
    _record_active("all_gather", int(out.numel()) * out.element_size(), tag, payload)
    return out


def psum(x: Any, axes: Axes, *, mesh, tag: str = "", payload: bool = True) -> Any:
    """Sum a tree over the ``axes`` of ``mesh``; books the tree's bytes."""
    group = axes_group(mesh, axes)
    with _span("all-reduce"):
        out = tree_map(lambda v: _all_reduce_sum(v, group), x)
    _record_active("psum", _tree_nbytes(out), tag, payload)
    return out


def pmean(x: Any, axes: Axes, *, mesh, tag: str = "", payload: bool = True,
          nbytes: Optional[int] = None) -> Any:
    """Mean of a tree over the ``axes`` of ``mesh`` (a sum, then a division
    by the group's size); books the tree's bytes, or ``nbytes`` (the global
    tree's, when ``x`` holds shards)."""
    import torch.distributed as dist

    group = axes_group(mesh, axes)
    n = dist.get_world_size(group)
    with _span("all-reduce"):
        out = tree_map(lambda v: _all_reduce_sum(v, group) / n, x)
    _record_active("pmean", _tree_nbytes(out) if nbytes is None else int(nbytes), tag,
                   payload)
    return out


def note(kind: str, tree: Any, *, nbytes: Optional[int] = None,
         tag: str = "", payload: bool = True) -> Any:
    """Book a collective without performing one (identity): ``tree``'s bytes
    unless ``nbytes`` overrides them (compressed wire formats)."""
    _record_active(kind, _tree_nbytes(tree) if nbytes is None else int(nbytes),
                   tag, payload)
    return tree


def note_all_reduce(tree: Any, *, nbytes: Optional[int] = None,
                    tag: str = "", payload: bool = True) -> Any:
    """Book an all-reduce of ``tree`` (identity); ``nbytes`` books another
    wire size than the tree's (compressed all-reduce)."""
    return note("all_reduce", tree, nbytes=nbytes, tag=tag, payload=payload)
