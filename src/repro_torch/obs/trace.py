"""Span tracing: the one observability vocabulary for train / sim / serve.

A ``Span`` is a half-open interval ``[t0, t1]`` on a *lane* (one lane per
simulated worker, pod link or serving slot) with a ``kind`` drawn from the
fixed taxonomy below, an optional byte payload (``nbytes`` — always
ledger-measured, never re-derived) and an optional parent for nesting.

Two clock modes (``Tracer(clock=...)``):

* ``"sim"`` — deterministic simulated time: every span's ``t0``/``t1`` is
  supplied by the caller (the discrete-event loop, the traffic replay).
  Nothing here reads a wall clock, so same spec seed ⇒ identical spans ⇒
  byte-identical Perfetto export (``repro_torch.obs.export``).
* ``"wall"`` — host wall clock: ``Tracer.span`` is a context manager that
  stamps ``perf_counter`` deltas against the tracer's epoch and nests via
  an explicit span stack (the real-path ``launch.train --trace`` mode).
  With ``device=True`` (and a CUDA device) each span also records a CUDA
  event pair on the current stream; ``resolve()`` turns them into the
  span's ``device_ms``.

One wall tracer may be made the process's active one (``activate`` /
``deactivate``, or ``with active(tracer):``).  The program's modules call
``span(name, **attrs)`` and ``count(name)`` at their layer boundaries; with
no active tracer ``span`` returns one shared no-op context manager and
``count`` returns at once, so an untraced run pays one global read a site.

The tracer is bookkeeping-free by design: consumers derive timelines
(``export``) and attribution (``report``) from the SAME spans — there is
never a second accounting path that could drift from what the pricing or
the ledger recorded.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

#: the span taxonomy — every span's ``kind`` is one of these
KINDS = (
    "compute",          # local FLOPs (oracle calls, prefill/decode math)
    "comm.exposed",     # collective time on the critical path
    "comm.overlapped",  # collective time hidden behind compute (buckets)
    "queue.contention", # waiting on a shared link / admission queue
    "barrier",          # waiting on slower participants (+ round markers)
    "checkpoint",       # save/restore round-trips, failure recovery
    "prefill",          # serving: admission prefill on a slot
    "decode",           # serving: decode occupancy of a slot
)

CLOCKS = ("sim", "wall")


def worker_lane(worker: int) -> str:
    """Canonical lane name for a simulated worker (-1 = cluster-wide)."""
    return f"worker/{worker}" if worker >= 0 else "cluster"


def slot_lane(slot: int) -> str:
    """Canonical lane name for a serving slot (-1 = retired at prefill)."""
    return f"slot/{slot}" if slot >= 0 else "slot/prefill-only"


@dataclass
class Span:
    """One traced interval.  ``src_kind`` carries the legacy event-tuple
    kind for spans that ARE committed events of the sim's event loop — the
    ``(time, kind, worker)`` determinism trace is derived from exactly
    those spans (``src_kind is None`` marks annotation-only spans that add
    timeline detail without entering the tuple view)."""

    kind: str
    lane: str
    t0: float
    t1: float
    name: str = ""
    nbytes: int = 0
    worker: int = -1
    src_kind: Optional[str] = None
    parent: int = -1

    # a program span's extras, set on the instance; class attributes and not
    # dataclass fields, so a span's fields (``astuple``, ``==``) stay the
    # reference's
    attrs = None       # a few scalars (worker, rid, tokens, ...)
    device_ms = None   # CUDA-event time, set by Tracer.resolve
    counts = None      # count() calls while the span was innermost

    def __post_init__(self):
        assert self.kind in KINDS, \
            f"unknown span kind {self.kind!r}; have {KINDS}"
        assert self.t1 >= self.t0 - 1e-12, \
            f"span ends before it starts: [{self.t0}, {self.t1}]"

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


#: a counter sample: (t, lane, name, value) — e.g. cumulative ledger bytes
CounterSample = Tuple[float, str, str, float]


class Tracer:
    """Collects spans and counter samples under one clock mode; a wall
    tracer made with ``device=True`` times each span on the card too."""

    def __init__(self, clock: str = "sim", device: bool = False):
        assert clock in CLOCKS, f"unknown clock {clock!r}; have {CLOCKS}"
        self.clock = clock
        self.spans: List[Span] = []
        self.counters: List[CounterSample] = []
        self.totals: Dict[str, float] = {}
        self._stack: List[int] = []
        self._epoch = time.perf_counter() if clock == "wall" else 0.0
        self.device = device and clock == "wall" and _cuda_available()
        self._pending: List[Tuple[int, object, object]] = []

    @property
    def epoch(self) -> float:
        """``time.perf_counter()`` at the tracer's time 0 (wall mode): a
        span's ``t0 + epoch`` is on any clock tied to ``perf_counter``."""
        return self._epoch

    # ------------------------------------------------------------------ #
    def now(self) -> float:
        """Wall-clock seconds since the tracer's epoch (wall mode only)."""
        assert self.clock == "wall", "sim-mode time is supplied by callers"
        return time.perf_counter() - self._epoch

    def add(self, kind: str, lane: str, t0: float, t1: float, *,
            name: str = "", nbytes: int = 0, worker: int = -1,
            src_kind: Optional[str] = None,
            parent: Optional[int] = None) -> int:
        """Record a completed span (sim mode's only entry point); returns
        its index.  ``parent=None`` nests under the innermost open wall
        span, if any."""
        if parent is None:
            parent = self._stack[-1] if self._stack else -1
        self.spans.append(Span(kind, lane, float(t0), float(t1), name=name,
                               nbytes=int(nbytes), worker=worker,
                               src_kind=src_kind, parent=parent))
        return len(self.spans) - 1

    @contextmanager
    def span(self, kind: str, lane: str, *, name: str = "",
             nbytes: int = 0, attrs: Optional[Dict] = None) -> Iterator[Span]:
        """Wall-clock span context manager: stamps ``now()`` on entry and
        exit, nests under the enclosing ``span``.  The yielded ``Span`` is
        live — mutate ``nbytes``/``name``/``attrs`` inside the block (e.g.
        once the CommLedger has booked the step)."""
        assert self.clock == "wall", "use add() with explicit times in sim mode"
        idx = self.add(kind, lane, self.now(), self.now(), name=name,
                       nbytes=nbytes)
        if attrs:
            self.spans[idx].attrs = dict(attrs)
        start = self._event()
        self._stack.append(idx)
        try:
            yield self.spans[idx]
        finally:
            self._stack.pop()
            if start is not None:
                self._pending.append((idx, start, self._event()))
            self.spans[idx].t1 = self.now()

    def counter(self, t: float, lane: str, name: str, value: float) -> None:
        self.counters.append((float(t), lane, name, float(value)))

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to ``name`` on the innermost open span and on the
        tracer's total, and sample the total as a counter (wall mode)."""
        lane = "program"
        if self._stack:
            sp = self.spans[self._stack[-1]]
            sp.counts = sp.counts or {}
            sp.counts[name] = sp.counts.get(name, 0) + n
            lane = sp.lane
        self.totals[name] = self.totals.get(name, 0) + n
        self.counter(self.now(), lane, name, self.totals[name])

    def lane(self) -> str:
        """The innermost open span's lane, else ``"program"``."""
        return self.spans[self._stack[-1]].lane if self._stack else "program"

    def _event(self):
        """A CUDA timing event recorded on the current stream, or None."""
        if not self.device:
            return None
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def resolve(self) -> None:
        """Synchronize the card and store each closed span's ``device_ms``
        (the elapsed time between its two events); call once after the
        traced work."""
        if not self._pending:
            return
        import torch

        torch.cuda.synchronize()
        for idx, start, end in self._pending:
            self.spans[idx].device_ms = start.elapsed_time(end)
        self._pending = []

    # ------------------------------------------------------------------ #
    def lanes(self) -> List[str]:
        """Lane names in deterministic first-appearance order."""
        seen: List[str] = []
        for s in self.spans:
            if s.lane not in seen:
                seen.append(s.lane)
        for _, lane, _, _ in self.counters:
            if lane not in seen:
                seen.append(lane)
        return seen

    def extend(self, spans: List[Span],
               counters: Optional[List[CounterSample]] = None) -> None:
        """Adopt pre-built spans (e.g. ``SimResult.spans``) wholesale."""
        self.spans.extend(spans)
        if counters:
            self.counters.extend(counters)


def _cuda_available() -> bool:
    try:
        import torch
    except ImportError:
        return False
    return torch.cuda.is_available()


# ---------------------------------------------------------------------- #
# the process's active tracer, and the program's span sites
# ---------------------------------------------------------------------- #
_ACTIVE: Optional[Tracer] = None


class _NoSpan:
    """The one context manager every span site gets with no active tracer."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def activate(tracer: Tracer) -> Tracer:
    """Make ``tracer`` (a wall tracer) the one the program's ``span`` and
    ``count`` record into; raises if one is active already."""
    global _ACTIVE
    if tracer.clock != "wall":
        raise ValueError("only a wall-clock tracer can be activated")
    if _ACTIVE is not None:
        raise RuntimeError("a tracer is already active")
    _ACTIVE = tracer
    return tracer


def deactivate() -> Optional[Tracer]:
    """Stop recording; returns the tracer that was active, if any."""
    global _ACTIVE
    tracer, _ACTIVE = _ACTIVE, None
    return tracer


@contextmanager
def active(tracer: Tracer) -> Iterator[Tracer]:
    """``activate(tracer)`` for the block."""
    activate(tracer)
    try:
        yield tracer
    finally:
        deactivate()


def tracing() -> bool:
    """Whether a tracer is active."""
    return _ACTIVE is not None


def span(name: str, kind: str = "compute", **attrs):
    """A span named ``name`` on the active tracer, on the lane of the span
    around it; ``NO_SPAN`` (the same object every call) when none is active."""
    tr = _ACTIVE
    if tr is None:
        return NO_SPAN
    return tr.span(kind, tr.lane(), name=name, attrs=attrs)


def count(name: str, n: float = 1) -> None:
    """``Tracer.count`` on the active tracer; nothing when none is active."""
    tr = _ACTIVE
    if tr is not None:
        tr.count(name, n)


def interval(name: str, start: float, lane: str, kind: str = "compute",
             **attrs) -> None:
    """A span from ``start`` (a ``time.perf_counter()`` reading) to now on
    ``lane``, outside the span stack (e.g. a request's wait in a queue);
    nothing when no tracer is active."""
    tr = _ACTIVE
    if tr is None:
        return
    idx = tr.add(kind, lane, start - tr.epoch, tr.now(), name=name, parent=-1)
    tr.spans[idx].attrs = dict(attrs) or None
