"""Deterministic discrete-event core: per-worker clocks + a totally ordered
event trace.

Counterpart of ``repro.sim.events``, a copy over ``repro_torch.obs`` spans.

The simulator's determinism guarantee (README §repro.sim) rests entirely on
this module: the two collectives (``barrier_all_reduce`` and its
bounded-staleness twin ``async_all_reduce``) commit each round's per-worker
completions in sorted ``(time, worker)`` order — a pure function of clocks
and compute durations, with worker index as the tie-break — so two runs
with the same inputs record identical traces.  (``EventLoop`` also keeps a
``(time, seq)``-ordered heap with FIFO tie-break for callers that schedule
genuinely future events; the collectives commit directly via ``record``
because a fast worker's unbarriered round may legitimately start before a
slower worker's already-committed event.)  Nothing here reads wall clocks
or global RNG state; all randomness enters through the seeded draws in
``repro_torch.sim.cluster``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.obs.trace import Span, worker_lane


class Event(NamedTuple):
    time: float
    seq: int       # scheduling order — the deterministic tiebreak
    kind: str
    worker: int    # -1 for cluster-wide events


#: what the determinism tests compare: (time, kind, worker) triples in the
#: exact order the loop committed them.  Since the obs layer landed this is
#: a DERIVED VIEW over the committed spans (``EventLoop.trace``), so the
#: determinism suites pin the span path for free.
TraceEntry = Tuple[float, str, int]

#: default span-kind taxonomy for committed legacy event kinds; collective
#: kinds ("all_reduce", "async_exchange", custom) default to comm.exposed
_SPAN_KIND = {
    "compute": "compute",
    "barrier": "barrier",
    "fail": "checkpoint",
    "restore": "checkpoint",
    "leave": "checkpoint",
    "rejoin": "checkpoint",
}


@dataclass
class EventLoop:
    """Min-heap of future events + the committed span list.

    Every commit is a ``repro_torch.obs.trace.Span`` (interval, lane, kind
    taxonomy, ledger bytes); the historical ``(time, kind, worker)`` tuple
    trace is derived from the spans that carry a ``src_kind`` — annotation
    spans (``annotate``) enrich the timeline without entering the tuple
    view, so the bit-identity contract and the Perfetto export read the
    SAME committed events.
    """

    _heap: List[Event] = field(default_factory=list)
    _seq: int = 0
    now: float = 0.0
    spans: List[Span] = field(default_factory=list)

    @property
    def trace(self) -> List[TraceEntry]:
        """The legacy determinism view, derived from the committed spans."""
        return [(s.t1, s.src_kind, s.worker)
                for s in self.spans if s.src_kind is not None]

    def schedule(self, at: float, kind: str, worker: int = -1) -> Event:
        assert at >= self.now - 1e-12, f"scheduling into the past: {at} < {self.now}"
        ev = Event(float(at), self._seq, kind, worker)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        """Commit the earliest pending event: advances ``now``, records it."""
        ev = heapq.heappop(self._heap)
        self.now = max(self.now, ev.time)
        self._commit(ev.time, ev.kind, ev.worker, ev.time, None, 0)
        return ev

    def record(self, at: float, kind: str, worker: int = -1, *,
               t0: Optional[float] = None, span_kind: Optional[str] = None,
               nbytes: int = 0) -> None:
        """Commit an event (no heap round-trip): enters the tuple trace at
        ``at`` with ``kind``, and the span timeline as ``[t0, at]`` (default
        instantaneous) of taxonomy kind ``span_kind`` (default mapped from
        the legacy kind)."""
        self.now = max(self.now, float(at))
        self._commit(float(at), kind, worker, t0, span_kind, nbytes)

    def annotate(self, kind: str, t0: float, t1: float, *, worker: int = -1,
                 lane: Optional[str] = None, nbytes: int = 0,
                 name: str = "") -> None:
        """Add an annotation-only span (never enters the tuple trace):
        barrier waits, queue/contention waits, overlapped comm."""
        if t1 <= t0:
            return
        self.spans.append(Span(kind, lane or worker_lane(worker),
                               float(t0), float(t1), name=name,
                               nbytes=int(nbytes), worker=worker))

    def _commit(self, at: float, kind: str, worker: int,
                t0: Optional[float], span_kind: Optional[str],
                nbytes: int) -> None:
        sk = span_kind or _SPAN_KIND.get(kind, "comm.exposed")
        self.spans.append(Span(sk, worker_lane(worker),
                               float(at if t0 is None else t0), float(at),
                               name=kind, nbytes=int(nbytes), worker=worker,
                               src_kind=kind))

    @property
    def pending(self) -> int:
        return len(self._heap)


@dataclass
class WorkerClocks:
    """One simulated clock per worker."""

    t: List[float]

    @classmethod
    def start(cls, m: int, at: float = 0.0) -> "WorkerClocks":
        return cls([float(at)] * m)

    @property
    def m(self) -> int:
        return len(self.t)

    def advance(self, worker: int, dt: float) -> float:
        self.t[worker] += dt
        return self.t[worker]

    def barrier(self, active: Optional[Sequence[int]] = None) -> float:
        """Synchronize: every (active) clock jumps to the latest of them —
        returns that time.  Inactive workers (elastic leavers) keep their
        clocks and do not gate the barrier."""
        if active is None:
            sync = max(self.t)
            self.t = [sync] * self.m
            return sync
        sync = max(self.t[i] for i in active)
        for i in active:
            self.t[i] = sync
        return sync

    def set_all(self, at: float, active: Optional[Sequence[int]] = None) -> None:
        if active is None:
            self.t = [float(at)] * self.m
        else:
            for i in active:
                self.t[i] = float(at)


def barrier_all_reduce(
    loop: EventLoop,
    clocks: WorkerClocks,
    compute_dts: Sequence[float],
    comm_time: float,
    *,
    kind: str = "all_reduce",
    active: Optional[Sequence[int]] = None,
    nbytes: int = 0,
) -> float:
    """The bulk-synchronous collective: per-worker compute, barrier, exchange.

    Commits a ``compute`` completion per (active) worker in (time, worker)
    order — identical to draining the loop's heap, whose FIFO tiebreak is
    the worker-ascending scheduling order, but additionally valid when a
    fast worker's round starts before an already-committed event of a
    slower worker (the first barriered FO sync after a run of unbarriered
    async rounds) — barriers, then charges ``comm_time`` once: the model
    every method in ``repro_torch.core`` follows.  Returns the completion time,
    with every participating clock advanced to it.  ``comm_time == 0``
    records a plain ``barrier`` event (an iteration with no exchange, e.g.
    PA-SGD between averaging rounds).  ``active`` (elastic membership)
    restricts participation: left workers neither compute nor gate the
    barrier.

    Span timeline: each worker's compute interval, a ``barrier`` wait
    annotation for every worker that finished before the slowest, and one
    ``comm.exposed`` span ``[sync, done]`` carrying ``nbytes`` (the round's
    ledger bytes).
    """
    assert len(compute_dts) == clocks.m
    workers = range(clocks.m) if active is None else active
    dones = sorted((clocks.t[i] + compute_dts[i], i) for i in workers)
    for t_done, i in dones:
        loop.record(t_done, "compute", i, t0=t_done - compute_dts[i])
        clocks.t[i] = t_done
    sync = clocks.barrier(active)
    for t_done, i in dones:
        loop.annotate("barrier", t_done, sync, worker=i, name="barrier.wait")
    if comm_time > 0:
        done = sync + comm_time
        loop.record(done, kind, t0=sync, nbytes=nbytes)
    else:
        done = sync
        loop.record(done, "barrier", nbytes=nbytes)
    clocks.set_all(done, active)
    return done


@dataclass
class SharedLink:
    """A shared-bandwidth resource serving one transfer at a time.

    ``acquire(at, duration)`` queues a transfer that becomes ready at
    ``at``: it starts at ``max(at, free_at)`` — waiting behind whatever is
    already on the wire — and returns its completion time, advancing the
    link's busy horizon.  Callers MUST acquire in deterministic
    (ready_time, worker) order; the FIFO discipline then yields the
    deterministic contention sharing the README §repro.sim contract pins:
    two transfers of duration ``g`` both ready at ``T`` complete at
    ``T + g`` and ``T + 2g`` (aggregate throughput = fair bandwidth share,
    with a deterministic completion order instead of fractional-rate
    bookkeeping).  Zero-duration requests pass through untouched.
    """

    free_at: float = 0.0

    def acquire(self, at: float, duration: float) -> float:
        if duration <= 0.0:
            return float(at)
        start = max(float(at), self.free_at)
        self.free_at = start + float(duration)
        return self.free_at


@dataclass
class LinkContention:
    """Per-link contention state for unbarriered exchanges: one
    ``SharedLink`` per pod plus one shared inter-pod link (the multi-pod
    bottleneck).  A worker's exchange routes through its pod's link for the
    intra-pod component, then the inter-pod link for the inter component
    (zero on single-pod clusters) — concurrent transfers on the same link
    serialize instead of being priced independently.

    Barriered collectives do NOT route through these links: the
    ``CollectiveModel`` already prices the whole membership's joint
    algorithm, and the barrier guarantees nothing else is in flight.
    """

    m: int
    pods: int = 1
    pod_links: Optional[List[SharedLink]] = None
    inter: SharedLink = field(default_factory=SharedLink)

    def __post_init__(self):
        assert self.pods >= 1 and self.m >= 1
        if self.pod_links is None:
            self.pod_links = [SharedLink() for _ in range(self.pods)]

    def pod_of(self, worker: int) -> int:
        wpp = max(1, self.m // self.pods)
        return min(worker // wpp, self.pods - 1)

    def transfer(self, worker: int, at: float, intra_s: float,
                 inter_s: float = 0.0) -> float:
        t1 = self.pod_links[self.pod_of(worker)].acquire(at, intra_s)
        return self.inter.acquire(t1, inter_s)

    def clone(self) -> "LinkContention":
        return LinkContention(
            self.m, self.pods,
            [SharedLink(l.free_at) for l in self.pod_links],
            SharedLink(self.inter.free_at))

    def adopt(self, other: "LinkContention") -> None:
        for mine, theirs in zip(self.pod_links, other.pod_links):
            mine.free_at = theirs.free_at
        self.inter.free_at = other.inter.free_at


class AsyncEntry(NamedTuple):
    """One worker's planned unbarriered round: compute ``[start, t_done]``,
    then an exchange of duration ``comm_s`` ending at ``end`` (any gap
    between ``t_done`` and ``end - comm_s`` is shared-link queueing)."""

    t_done: float
    worker: int
    start: float
    end: float
    comm_s: float


def plan_async_round(
    clocks: WorkerClocks,
    compute_dts: Sequence[float],
    gate: float,
    workers: Sequence[int],
    comm_for,
    contention: Optional[LinkContention] = None,
):
    """Pure planning pass for one unbarriered round.

    ``comm_for(i) -> (intra_s, inter_s)`` gives worker ``i``'s exchange
    duration split (overlap-aware: the runner passes the EXPOSED time).
    Returns ``(entries, trial)`` where ``entries`` is a list of
    ``AsyncEntry`` in deterministic (time, worker) order and ``trial`` is
    the advanced CLONE of ``contention`` (or None) — nothing global is
    mutated, so the runner can price a tentative commit (failure
    preemption) and only ``adopt`` the link state if the round really
    lands.
    """
    trial = contention.clone() if contention is not None else None
    entries = []
    for t_done, i in sorted((max(clocks.t[i], gate) + compute_dts[i], i)
                            for i in workers):
        intra_s, inter_s = comm_for(i)
        if trial is not None:
            end = trial.transfer(i, t_done, intra_s, inter_s)
        else:
            end = t_done + intra_s + inter_s
        entries.append(AsyncEntry(t_done, i, t_done - compute_dts[i], end,
                                  intra_s + inter_s))
    return entries, trial


def commit_async_round(
    loop: EventLoop,
    clocks: WorkerClocks,
    entries,
    *,
    kind: str = "async_exchange",
    nbytes: int = 0,
) -> float:
    """Commit a planned unbarriered round: per-worker ``compute`` events in
    the plan's (time, worker) order, clocks advanced to each worker's
    exchange end, one ``kind`` event at the round's commit time (the latest
    participating clock).

    Span timeline: each worker's compute interval, a ``queue.contention``
    annotation covering any shared-link wait between compute completion and
    exchange start, a ``comm.exposed`` annotation for the exchange itself,
    and the round-commit event as a zero-length ``comm.exposed`` span
    carrying ``nbytes`` (the round's ledger bytes, booked once)."""
    for e in entries:
        loop.record(e.t_done, "compute", e.worker, t0=e.start)
        comm_t0 = e.end - e.comm_s
        if comm_t0 - e.t_done > 1e-12:  # real link wait, not float residue
            loop.annotate("queue.contention", e.t_done, comm_t0,
                          worker=e.worker, name="link.wait")
        loop.annotate("comm.exposed", comm_t0, e.end, worker=e.worker,
                      name="exchange")
        clocks.t[e.worker] = e.end
    done = max(e.end for e in entries)
    loop.record(done, kind, nbytes=nbytes)
    return done


def async_all_reduce(
    loop: EventLoop,
    clocks: WorkerClocks,
    compute_dts: Sequence[float],
    comm_time: float,
    gate: float,
    *,
    kind: str = "async_exchange",
    active: Optional[Sequence[int]] = None,
    contention: Optional[LinkContention] = None,
) -> float:
    """Bounded-staleness round: compute + exchange WITHOUT a barrier.

    Each (active) worker starts at ``max(own clock, gate)`` — ``gate`` is
    the commit time of the round ``max_staleness + 1`` back, which is how
    the runner enforces that no worker runs more than ``max_staleness``
    rounds ahead of the slowest — computes for its own ``dt``, then pays
    ``comm_time`` for its own unbarriered exchange.  Clocks diverge; fast
    workers pull ahead.  With ``contention``, the per-worker exchanges
    additionally serialize through the shared links in the same
    deterministic (time, worker) order (``plan_async_round``).

    Completions are committed with ``loop.record`` in (time, worker) order
    *within the round*; across rounds a fast worker's completion may carry
    an earlier timestamp than an already-committed slow-worker event — the
    trace is a deterministic function of the inputs either way, which is
    all the determinism contract pins.  Returns the round's commit time
    (the latest participating clock, recorded as one ``kind`` event).
    """
    assert len(compute_dts) == clocks.m
    workers = list(range(clocks.m)) if active is None else list(active)
    comm = comm_time if comm_time > 0 else 0.0
    entries, trial = plan_async_round(clocks, compute_dts, gate, workers,
                                      lambda i: (comm, 0.0), contention)
    if contention is not None and trial is not None:
        contention.adopt(trial)
    return commit_async_round(loop, clocks, entries, kind=kind)
