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

``psum``, ``pmean`` and ``all_gather`` need a process group and raise until
ROADMAP Queue 1 item 9 (``torch.distributed``) lands; ``note`` and
``note_all_reduce`` book an exchange without performing one, which is how
the single-card round executor books its collectives.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.tree import tree_leaves

_ACTIVE: List[Tuple["CommLedger", str]] = []


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
# collectives over a process group (ROADMAP Queue 1 item 9)
# --------------------------------------------------------------------------- #
def _needs_process_group(name: str):
    raise NotImplementedError(
        f"{name} needs a torch.distributed process group, which the port gains "
        f"with ROADMAP Queue 1 item 9 (core/distributed); on one card book an "
        f"exchange with note()/note_all_reduce()")


def all_gather(x, axes, *, tiled: bool = False, tag: str = "",
               payload: bool = True):
    _needs_process_group("all_gather")


def psum(x, axes, *, tag: str = "", payload: bool = True):
    _needs_process_group("psum")


def pmean(x, axes, *, tag: str = "", payload: bool = True):
    _needs_process_group("pmean")


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
