"""Trace-derived cost attribution: where a run's time actually went.

``attribution`` folds a span list into per-kind seconds, per-kind bytes and
per-lane breakdowns, plus the headline fractions the frontier benchmarks
assert on:

* ``exposed_comm_fraction`` — comm.exposed seconds / makespan: the share of
  the run's critical path spent on collectives that compute could not hide
  (``benchmarks/sim_frontier.py --trace-report`` pins HO-SGD ≤ 0.05 vs
  sync-SGD ≥ 0.2 on the overlap cluster, cross-checked against the
  ``costs.exposed_comm_time`` closed forms within 1e-9);
* ``queue_wait_fraction`` — shared-link / admission queueing per makespan;
* ``bytes_total`` — ledger bytes carried on spans, never re-derived.

Everything here runs equally on live ``Span`` objects or on spans
reconstructed from an exported Perfetto JSON (``export.spans_from_events``)
— the attribution is a pure function of the artifact, so a report can be
regenerated long after the run.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.obs.export import load_trace_events, spans_from_events
from repro_torch.obs.trace import KINDS, Span


def attribution(spans: Sequence[Span]) -> Dict:
    """Fold spans into per-kind / per-lane time + byte attribution."""
    kind_s = {k: 0.0 for k in KINDS}
    kind_bytes = {k: 0 for k in KINDS}
    lane_s: Dict[str, Dict[str, float]] = {}
    t_min, t_max = float("inf"), 0.0
    for s in spans:
        kind_s[s.kind] += s.duration
        kind_bytes[s.kind] += s.nbytes
        per = lane_s.setdefault(s.lane, {})
        per[s.kind] = per.get(s.kind, 0.0) + s.duration
        t_min = min(t_min, s.t0)
        t_max = max(t_max, s.t1)
    makespan = (t_max - t_min) if spans else 0.0
    span = makespan if makespan > 0 else 1.0
    return {
        "n_spans": len(spans),
        "makespan_s": makespan,
        "kind_seconds": kind_s,
        "kind_bytes": kind_bytes,
        "lane_seconds": lane_s,
        "bytes_total": sum(kind_bytes.values()),
        "exposed_comm_fraction": kind_s["comm.exposed"] / span,
        "overlapped_comm_fraction": kind_s["comm.overlapped"] / span,
        "queue_wait_fraction": kind_s["queue.contention"] / span,
        "barrier_fraction": kind_s["barrier"] / span,
    }


def attribution_from_file(path: str) -> Dict:
    """Attribution computed purely from an exported trace JSON."""
    return attribution(spans_from_events(load_trace_events(path)))


def format_report(att: Dict, *, title: str = "trace") -> List[str]:
    """Human-readable attribution lines (the CLI/benchmark print format)."""
    lines = [f"# {title}: {att['n_spans']} spans over "
             f"{att['makespan_s']:.6g}s, {att['bytes_total']} bytes"]
    for k in KINDS:
        s = att["kind_seconds"][k]
        if s <= 0.0 and att["kind_bytes"][k] <= 0:
            continue
        frac = s / att["makespan_s"] if att["makespan_s"] > 0 else 0.0
        lines.append(f"{title}/{k},{s:.6g}s,frac={frac:.4f},"
                     f"bytes={att['kind_bytes'][k]}")
    lines.append(
        f"{title}/headline,exposed_comm_fraction="
        f"{att['exposed_comm_fraction']:.4f},queue_wait_fraction="
        f"{att['queue_wait_fraction']:.4f}")
    return lines
