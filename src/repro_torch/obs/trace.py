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

The tracer is bookkeeping-free by design: consumers derive timelines
(``export``) and attribution (``report``) from the SAME spans — there is
never a second accounting path that could drift from what the pricing or
the ledger recorded.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

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
    """Collects spans and counter samples under one clock mode."""

    def __init__(self, clock: str = "sim"):
        assert clock in CLOCKS, f"unknown clock {clock!r}; have {CLOCKS}"
        self.clock = clock
        self.spans: List[Span] = []
        self.counters: List[CounterSample] = []
        self._stack: List[int] = []
        self._epoch = time.perf_counter() if clock == "wall" else 0.0

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
             nbytes: int = 0) -> Iterator[Span]:
        """Wall-clock span context manager: stamps ``now()`` on entry and
        exit, nests under the enclosing ``span``.  The yielded ``Span`` is
        live — mutate ``nbytes``/``name`` inside the block (e.g. once the
        CommLedger has booked the step)."""
        assert self.clock == "wall", "use add() with explicit times in sim mode"
        idx = self.add(kind, lane, self.now(), self.now(), name=name,
                       nbytes=nbytes)
        self._stack.append(idx)
        try:
            yield self.spans[idx]
        finally:
            self._stack.pop()
            self.spans[idx].t1 = self.now()

    def counter(self, t: float, lane: str, name: str, value: float) -> None:
        self.counters.append((float(t), lane, name, float(value)))

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
