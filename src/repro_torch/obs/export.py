"""Chrome/Perfetto ``trace_event`` export of traced spans.

Emits the JSON-object form (``{"traceEvents": [...]}``) that Perfetto and
``chrome://tracing`` load directly:

* one *thread* per lane (``tid`` = the lane's first-appearance index, with a
  ``thread_name`` metadata event naming it), all under one process whose
  ``process_name`` is the trace's title — so the timeline shows one row per
  worker / pod link / serving slot;
* one complete event (``ph: "X"``) per span — ``ts``/``dur`` in
  microseconds, ``cat`` = the span kind, ``args`` carrying the byte payload
  and the source event kind, and, where set, the span's ``attrs``,
  ``device_ms`` and ``counts`` (a program span's);
* one counter event (``ph: "C"``) per counter sample (ledger bytes etc.).

Serialization is deterministic: events are emitted in span order with
sorted keys and fixed separators, so the determinism contract extends to
the artifact itself — same spec seed ⇒ byte-identical trace JSON (pinned
in ``tests/test_obs.py``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.trace import CounterSample, Span, Tracer

_S_TO_US = 1e6


def trace_events(spans: Sequence[Span],
                 counters: Sequence[CounterSample] = (),
                 *, title: str = "repro") -> List[Dict]:
    """Flatten spans + counters into a ``trace_event`` list."""
    lanes: List[str] = []
    for s in spans:
        if s.lane not in lanes:
            lanes.append(s.lane)
    for _, lane, _, _ in counters:
        if lane not in lanes:
            lanes.append(lane)
    tid = {lane: i for i, lane in enumerate(lanes)}

    events: List[Dict] = [{
        "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
        "args": {"name": title},
    }]
    for lane in lanes:
        events.append({
            "ph": "M", "pid": 1, "tid": tid[lane], "name": "thread_name",
            "args": {"name": lane},
        })
    for s in spans:
        args: Dict = {"nbytes": s.nbytes}
        if s.src_kind is not None:
            args["src"] = s.src_kind
        if s.worker >= 0:
            args["worker"] = s.worker
        if s.attrs:
            args["attrs"] = s.attrs
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        if s.counts:
            args["counts"] = s.counts
        events.append({
            "ph": "X", "pid": 1, "tid": tid[s.lane],
            "name": s.name or s.kind, "cat": s.kind,
            "ts": s.t0 * _S_TO_US, "dur": (s.t1 - s.t0) * _S_TO_US,
            "args": args,
        })
    for t, lane, name, value in counters:
        events.append({
            "ph": "C", "pid": 1, "tid": tid[lane], "name": name,
            "ts": t * _S_TO_US, "args": {name: value},
        })
    return events


def validate_trace_events(events: Sequence[Dict]) -> None:
    """Schema check: every event carries what Perfetto's trace_event
    importer requires (raises AssertionError on violation)."""
    assert events, "empty trace"
    for ev in events:
        assert ev.get("ph") in ("X", "C", "M"), f"bad phase in {ev}"
        assert isinstance(ev.get("pid"), int) and isinstance(ev.get("tid"), int)
        assert "name" in ev
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], float) and isinstance(ev["dur"], float)
            assert ev["dur"] >= -1e-6, f"negative duration in {ev}"
        elif ev["ph"] == "C":
            assert isinstance(ev["ts"], float) and ev["args"]


def dumps(spans: Sequence[Span], counters: Sequence[CounterSample] = (),
          *, title: str = "repro") -> str:
    """Deterministic serialization (sorted keys, fixed separators)."""
    events = trace_events(spans, counters, title=title)
    validate_trace_events(events)
    return json.dumps({"displayTimeUnit": "ms", "traceEvents": events},
                      sort_keys=True, separators=(",", ":"))


def write_trace(path: str, source, counters: Optional[Sequence[CounterSample]] = None,
                *, title: str = "repro") -> str:
    """Write a Perfetto-loadable trace JSON; ``source`` is a ``Tracer`` or a
    span list.  Returns ``path``."""
    if isinstance(source, Tracer):
        spans, ctrs = source.spans, source.counters
    else:
        spans, ctrs = list(source), list(counters or [])
    if counters is not None:
        ctrs = list(counters)
    with open(path, "w") as f:
        f.write(dumps(spans, ctrs, title=title))
    return path


def load_trace_events(path: str) -> List[Dict]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    validate_trace_events(events)
    return events


def spans_from_events(events: Sequence[Dict]) -> List[Span]:
    """Reconstruct spans from exported trace events — the round-trip that
    lets ``report.attribution`` run on the artifact alone."""
    lane_of: Dict[int, str] = {}
    for ev in events:
        if ev["ph"] == "M" and ev["name"] == "thread_name":
            lane_of[ev["tid"]] = ev["args"]["name"]
    spans = []
    for ev in events:
        if ev["ph"] != "X":
            continue
        args = ev.get("args", {})
        t0 = ev["ts"] / _S_TO_US
        span = Span(
            kind=ev["cat"], lane=lane_of[ev["tid"]],
            t0=t0, t1=t0 + ev["dur"] / _S_TO_US,
            name=ev["name"], nbytes=int(args.get("nbytes", 0)),
            worker=int(args.get("worker", -1)),
            src_kind=args.get("src"))
        for extra in ("attrs", "device_ms", "counts"):
            if extra in args:
                setattr(span, extra, args[extra])
        spans.append(span)
    return spans
