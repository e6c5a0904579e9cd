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

The partitioned forward's all-reduces (``all_reduce_sum``) add every
rank's partial into one float32 accumulator as it is read, in group-rank
order, on every rank, so every rank of the group holds the same bits: the
replicated activations, a MoE layer's routing and the losses of one worker
must agree bit for bit on its ranks.  No rank holds every rank's partial at
once: on one card each rank reads the others' buffers in turn
(``_CardExchange.reduce_sum``); otherwise each rank's part is broadcast in
rank order into one receive buffer and added before the next arrives.  A
combine that is not a sum (``reduce_parts``: the vocab-parallel
cross-entropy's carries, the sequence-sharded decode's softmax partials)
stacks its small parts on a new leading dim, as ``gather_cat`` does.
These go through the same-card exchange or the group's backend (never
gloo's ``all_reduce``, which stages through host memory and sums in an
order of its own), and book nothing: they are the model's internal
traffic, not the method's exchange, as the reference's compiler books them
nowhere either.

``exchange`` is the partitioned layers' collective-permute: a fixed plan
says which slices of which ranks' tensors each rank takes, and only those
slices move (on one card each rank reads them from the owners' buffers;
otherwise one ``all_to_all_single`` of the slices alone).  Its transpose,
which returns each piece's gradient to its owner's slice, is an
``exchange`` over the ``transposed`` plan.

``GATHERS`` counts ``gather_cat``'s calls and the bytes of its results per
tuple of axes, ``REDUCES`` the partitioned forward's all-reduces and the
bytes of their reduced payloads, ``EXCHANGES`` ``exchange``'s calls and
the bytes a rank receives, and ``LABELS`` the
calls and bytes of every collective given a ``label`` (the partitioned
layers name theirs: ``mixer_uz``, ``qkv``, ``partial_logits``,
``attn_out``, ``logits``, and in a backward ``mixer_uz_grad`` and
``attn_out_grad``); ``reset_gathers`` sets all four to 0: the dry
run's collective bytes (``launch.dryrun``).  Every collective that runs
over the group (``gather_cat``, ``all_reduce_sum``, ``reduce_parts``,
``exchange``, ``all_gather``, ``psum``, ``pmean``) is one
``record_function`` span named ``collective:<kind>`` (``all-gather``,
``all-reduce`` or ``collective-permute``), which ``launch.overlap`` pairs
with the kernels a profiler trace shows between its ends.
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
#: axes -> [calls, bytes of the reduced payloads] of ``all_reduce_sum`` and
#: ``reduce_parts``
REDUCES: Dict[Tuple[str, ...], List[int]] = {}
#: axes -> [calls, bytes this rank received] of ``exchange``
EXCHANGES: Dict[Tuple[str, ...], List[int]] = {}
#: label -> [calls, bytes] of the collectives above that were given a label
LABELS: Dict[str, List[int]] = {}

#: ``exchange``'s plan: per destination rank, its pieces ``(source rank,
#: start, length)`` on the exchanged dim
Plan = Tuple[Tuple[Tuple[int, int, int], ...], ...]


def reset_gathers() -> None:
    """Set ``GATHERS``, ``REDUCES``, ``EXCHANGES`` and ``LABELS`` to 0."""
    GATHERS.clear()
    REDUCES.clear()
    EXCHANGES.clear()
    LABELS.clear()


def _count(table: Dict[Tuple[str, ...], List[int]], axes: Axes, nbytes: int,
           label: Optional[str] = None) -> None:
    for stat in ([table.setdefault((axes,) if isinstance(axes, str) else tuple(axes), [0, 0])]
                 + ([LABELS.setdefault(label, [0, 0])] if label else [])):
        stat[0] += 1
        stat[1] += nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
    """``gather_cat``, ``all_reduce_sum`` and ``exchange`` between ranks
    that share one CUDA device: each rank copies its part into a buffer of
    its own that every rank of the group has opened through a CUDA IPC
    handle, and every rank reads the parts device to device (``gather``:
    concatenated; ``reduce_sum``: added into one float32 accumulator one
    buffer at a time; ``permute``: only the pieces a plan gives it).  A barrier after the writes and one after the reads
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

    def _publish(self, x: torch.Tensor, reserve: int, read):
        """``read`` of every rank's buffer (uint8, in group-rank order)
        after each rank wrote its ``x`` there, between the two barriers;
        ``reserve`` is the bytes a buffer must hold, the same on every
        rank."""
        import torch.distributed as dist

        x = x.contiguous()
        n = _nbytes(x)
        if self.mine is None or self.mine.numel() < reserve:
            self._grow(max(reserve, 0 if self.mine is None else 2 * self.mine.numel()))
        stream = torch.cuda.current_stream(self.device)
        self.mine[:n].copy_(x.reshape(-1).view(torch.uint8))
        stream.synchronize()
        dist.barrier(group=self.group)
        out = read(self.parts)
        stream.synchronize()
        dist.barrier(group=self.group)
        return out

    def _read(self, x: torch.Tensor, combine):
        """``combine`` of every rank's ``x`` (a generator of views of their
        buffers, in group-rank order), between the two barriers."""
        n = _nbytes(x)
        return self._publish(x, n, lambda bufs: combine(
            p[:n].view(x.dtype).view(x.shape) for p in bufs))

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self._read(x, lambda parts: torch.cat(list(parts), dim))

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 sum of every rank's ``x``, each buffer read in turn."""
        return self._read(x, _accumulate)

    def permute(self, sends: List[torch.Tensor], moves, me: int, dtype) -> List[torch.Tensor]:
        """``_permute`` on the card: each rank writes its outgoing pieces
        into its buffer in ``moves``' order, and each reads only the pieces
        it receives from their senders' buffers."""
        es = torch.empty((), dtype=dtype).element_size()
        total: Dict[int, int] = {}
        for snd, _, shape in moves:
            total[snd] = total.get(snd, 0) + math.prod(shape) * es
        flat = (torch.cat([t.reshape(-1) for t in sends]) if sends else
                torch.empty(0, dtype=dtype, device=self.device))

        def read(bufs):
            off: Dict[int, int] = {}
            out = []
            for snd, rcv, shape in moves:
                a = off.get(snd, 0)
                off[snd] = a + math.prod(shape) * es
                if rcv == me:
                    out.append(bufs[snd][a:off[snd]].view(dtype).view(shape).clone())
            return out

        return self._publish(flat, max(total.values(), default=0), read)


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


def gather_cat(x: torch.Tensor, axes: Axes, *, mesh, dim: int,
               label: Optional[str] = None) -> torch.Tensor:
    """The parts of ``x`` over the ``axes`` of ``mesh``, concatenated on
    ``dim`` in group-rank order, on ``x``'s device; books nothing.  Ranks
    that share one card exchange CUDA parts device to device
    (``_CardExchange``); otherwise the group's backend carries them (gloo
    through host memory).  Counted in ``GATHERS`` (and ``LABELS`` under
    ``label``) at the result's bytes."""
    with _span("all-gather"):
        out = _gather_cat(x, axes, mesh, dim)
    _count(GATHERS, axes, _nbytes(out), label)
    return out


def reduce_parts(x: torch.Tensor, axes: Axes, *, mesh) -> torch.Tensor:
    """Every rank's ``x`` over the ``axes`` of ``mesh``, stacked on a new
    leading dim in group-rank order, for a combine that is not a sum and
    that every rank computes alike: the vocab-parallel cross-entropy's
    carries, the sequence-sharded decode's softmax partials.  Those parts
    are small (a few floats a row); a sum goes through ``all_reduce_sum``,
    which holds no stack.  Counted in ``REDUCES`` at ``x``'s bytes; books
    nothing."""
    with _span("all-reduce"):
        out = _gather_cat(x.unsqueeze(0), axes, mesh, 0)
    _count(REDUCES, axes, _nbytes(x))
    return out


def all_reduce_sum(x: torch.Tensor, axes: Axes, *, mesh,
                   label: Optional[str] = None) -> torch.Tensor:
    """The sum of ``x`` over the ``axes`` of ``mesh``, the same bits on
    every rank: the parts exchanged in ``x``'s dtype, added in group-rank
    order into one float32 accumulator as each is read, rounded once to
    ``x``'s dtype.  A rank holds ``x``, the accumulator and at most one
    received part.  Counted in ``REDUCES`` (and ``LABELS`` under
    ``label``) at ``x``'s bytes; books nothing."""
    with _span("all-reduce"):
        out = _reduce_sum(x, axes, mesh)
    _count(REDUCES, axes, _nbytes(x), label)
    return out.to(x.device, x.dtype)


def _accumulate(parts) -> torch.Tensor:
    """The float32 sum of ``parts`` in their order: a copy of the first,
    then each added in place (a bf16 part promoted inside the add, with no
    float32 copy of it)."""
    acc = None
    for part in parts:
        if acc is None:
            acc = part.to(torch.float32, copy=True)
        else:
            acc.add_(part)
    return acc


def _reduce_sum(x: torch.Tensor, axes: Axes, mesh) -> torch.Tensor:
    """``all_reduce_sum``'s float32 sum: through the same-card exchange, or
    one broadcast per source rank in group-rank order into a single receive
    buffer, each part added before the next arrives (on the host when gloo
    stages a CUDA part there)."""
    import torch.distributed as dist

    if x.is_cuda:
        card = _card_exchange(mesh, axes, x)
        if card is not None:
            return card.reduce_sum(x)
    group = axes_group(mesh, axes)
    y, _ = _staged(x.contiguous(), group)
    me = dist.get_rank(group)

    def received():
        buf = None
        for r in range(dist.get_world_size(group)):
            if r != me and buf is None:
                buf = torch.empty_like(y)
            part = y if r == me else buf
            dist.broadcast(part, src=dist.get_global_rank(group, r), group=group)
            yield part

    return _accumulate(received())


def _moves(plan: Plan, shape, dim: int) -> List[Tuple[int, int, Tuple[int, ...]]]:
    """The pieces of ``plan`` that cross ranks, as ``(sender, receiver,
    shape)`` in plan order (by destination, then its pieces)."""
    def piece(length):
        return tuple(length if d == dim else n for d, n in enumerate(shape))

    return [(src, dst, piece(length)) for dst, want in enumerate(plan)
            for src, _, length in want if src != dst]


def _permute(sends: List[torch.Tensor], moves, axes: Axes, mesh, proto: torch.Tensor
             ) -> List[torch.Tensor]:
    """Move pieces between the ranks of the group over ``axes``: ``moves``
    (the same list on every rank) are ``(sender, receiver, shape)`` group
    ranks; ``sends`` this rank's outgoing pieces in ``moves``' order.
    Returns the pieces this rank receives, in ``moves``' order, on
    ``proto``'s device and in its dtype.  Through the same-card exchange,
    or one ``all_to_all_single`` of the flattened pieces (gloo stages a
    CUDA payload through host memory); nothing else moves."""
    import torch.distributed as dist

    group = axes_group(mesh, axes)
    me = dist.get_rank(group)
    if proto.is_cuda:
        card = _card_exchange(mesh, axes, proto)
        if card is not None:
            return card.permute(sends, moves, me, proto.dtype)
    world = dist.get_world_size(group)
    mine = [(rcv, t) for (snd, rcv, _), t in
            zip([m for m in moves if m[0] == me], sends)]
    mine.sort(key=lambda p: p[0])                  # stable: plan order within a receiver
    in_splits, out_splits = [0] * world, [0] * world
    for rcv, t in mine:
        in_splits[rcv] += t.numel()
    incoming = [m for m in moves if m[1] == me]
    for snd, _, shape in incoming:
        out_splits[snd] += math.prod(shape)
    flat = (torch.cat([t.reshape(-1) for _, t in mine]) if mine else
            torch.empty(0, dtype=proto.dtype, device=proto.device))
    flat, staged = _staged(flat, group)
    got = torch.empty(sum(out_splits), dtype=flat.dtype, device=flat.device)
    dist.all_to_all_single(got, flat, out_splits, in_splits, group=group)
    got = got.to(proto.device) if staged else got
    # the senders' chunks in rank order, each in plan order
    off, at = 0, {}
    for snd in range(world):
        at[snd], off = off, off + out_splits[snd]
    out = []
    for snd, _, shape in incoming:
        k = math.prod(shape)
        out.append(got[at[snd]:at[snd] + k].view(shape))
        at[snd] += k
    return out


def exchange(x: torch.Tensor, plan: Plan, axes: Axes, *, mesh, dim: int,
             label: Optional[str] = None) -> List[torch.Tensor]:
    """This rank's pieces of the ranks' ``x`` over the ``axes`` of ``mesh``:
    XLA's collective-permute.  ``plan[d]`` lists the pieces that group rank
    ``d`` takes, each ``(source rank, start, length)`` on ``dim`` of the
    source's ``x``; every rank holds the same plan and an ``x`` of one
    shape off ``dim``.  Returns this rank's pieces in its plan's order (its own sliced
    here, copies).  Only the pieces that cross ranks move.  Counted in
    ``EXCHANGES`` (and ``LABELS`` under ``label``) at the bytes this rank
    receives; books nothing."""
    import torch.distributed as dist

    me = dist.get_rank(axes_group(mesh, axes))
    dim = dim % x.dim()
    moves = _moves(plan, x.shape, dim)
    sends = [x.narrow(dim, start, length) for dst, want in enumerate(plan)
             for src, start, length in want if src == me != dst]
    with _span("collective-permute"):
        got = iter(_permute(sends, moves, axes, mesh, x))
        out = [x.narrow(dim, start, length).clone() if src == me else next(got)
               for src, start, length in plan[me]]
    _count(EXCHANGES, axes, sum(_nbytes(t) for t, (src, _, _) in zip(out, plan[me])
                                if src != me), label)
    return out


def transposed(plan: Plan) -> Tuple[Plan, Tuple[Tuple[Tuple[int, int], ...], ...]]:
    """``exchange``'s transpose as an exchange: when group rank ``d`` holds
    its pieces' gradients concatenated on the exchanged dim in its plan's
    order, the plan that takes each back to its source (per destination,
    the pieces of every rank's plan that came from it, in rank and then
    plan order) and, per destination, where each lands on its ``x``:
    ``(start, length)`` in the same order."""
    back: List[List[Tuple[int, int, int]]] = [[] for _ in plan]
    lands: List[List[Tuple[int, int]]] = [[] for _ in plan]
    for d, want in enumerate(plan):
        at = 0
        for src, start, length in want:
            back[src].append((d, at, length))
            lands[src].append((start, length))
            at += length
    return tuple(map(tuple, back)), tuple(map(tuple, lands))


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
