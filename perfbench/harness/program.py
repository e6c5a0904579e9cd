"""The program's own spans in a traced window, and the numbers they give.

The port records spans and counts at its layer boundaries into the process's
active ``repro_torch.obs`` tracer (``fo.step``, ``fo.microbatch``,
``zo.loss``, ``engine.sumsq``, ``serve.admit``, ``model.prefill``,
``ssm.tail_state`` ...; README, PERF.md section 3).  ``ProgramWindow`` is the
harness's ``Window`` with such a tracer active inside it: on a card each
span also gets its CUDA-event time (``device_ms``).  After the window:

* ``ProgramWindow.summary(spans)`` is ``Window.summary`` with each idle gap
  named by the harness's span and then the program spans that cover the
  gap's midpoint, outermost first and the program's root span left out
  (``fo_step>fo.microbatch>fo.backward``);
* ``ProgramWindow.record()`` is what the readers below take from a run
  record's ``program`` key: each span on the host's ``perf_counter`` clock
  (``t0``, ``t1``), with ``device_ms``, ``attrs``, ``counts``, its parent,
  and for a root span the device's busy seconds inside it on the
  profiler's timeline (``busy_s``), and the tracer's count totals.

Each reader (one a metric: ``fo_mb_host_ms`` ...) returns None when the
spans or device times it reads are absent.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from harness.profile import Spans, Window, _events

#: lanes of spans that run outside the program's span stack (a request's wait)
_OFF_STACK = ("request/",)


class ProgramSpans(Spans):
    """The harness's spans, with ``at(t)`` extended by the program spans
    that cover ``t`` (``t`` on the host's ``perf_counter``)."""

    def __init__(self, harness: Spans, tracer):
        super().__init__()
        self.items = harness.items
        self.tracer = tracer

    def at(self, t: float) -> str:
        return name_at(super().at(t), self.tracer.spans, t - self.tracer.epoch)


def name_at(prefix: str, spans, t: float) -> str:
    """``prefix``, then ``>`` and each span of ``spans`` (``obs.Span``s on
    the tracer's clock) that covers ``t``, outermost first, without the
    root of the chain when a span below it covers ``t`` too."""
    chain = []
    for i, s in enumerate(spans):
        if s.t0 <= t <= s.t1 and not s.lane.startswith(_OFF_STACK):
            chain.append((s.t0, -s.t1, i))
    names = [spans[i].name for _, _, i in sorted(chain)]
    if len(names) > 1 and spans[sorted(chain)[0][2]].parent == -1:
        names = names[1:]
    return ">".join([prefix] + names)


class ProgramWindow(Window):
    """``Window(on)`` with a ``repro_torch.obs`` wall tracer active inside
    (its device events only when the profiler is on: a card)."""

    def __init__(self, on: bool):
        super().__init__(on)
        self.tracer = None
        self._active = contextlib.ExitStack()

    def __enter__(self):
        from repro_torch import obs

        super().__enter__()
        self.tracer = obs.Tracer(clock="wall", device=self.on)
        self._active.enter_context(obs.active(self.tracer))
        return self

    def __exit__(self, *exc):
        self._active.close()
        super().__exit__(*exc)
        self.tracer.resolve()
        return False

    def summary(self, spans: Spans, top: int = 10) -> Optional[Dict]:
        return super().summary(ProgramSpans(spans, self.tracer), top)

    def record(self) -> Dict:
        """The window's program spans and counts, for a run record's
        ``program`` key."""
        tr = self.tracer
        busy = _busy_intervals(self) if self.prof is not None else None
        out: List[Dict] = []
        for s in tr.spans:
            rec = {"name": s.name, "t0": s.t0 + tr.epoch, "t1": s.t1 + tr.epoch,
                   "parent": s.parent, "device_ms": s.device_ms, "attrs": s.attrs or {},
                   "counts": s.counts or {}}
            if busy is not None and s.parent == -1 and not s.lane.startswith(_OFF_STACK):
                rec["busy_s"] = _overlap(busy, rec["t0"], rec["t1"])
            out.append(rec)
        return {"spans": out, "counts": dict(tr.totals)}


def _busy_intervals(win: Window) -> List[tuple]:
    """The device's merged busy intervals on the host's clock (the marker
    ties the profiler's clock to ``perf_counter``, as ``Window.summary``)."""
    events = _events(win.prof)
    if not events:
        return []
    marks = [s for n, s, _ in events if win.MARKER in n]
    offset = (marks[0] if marks else min(s for _, s, _ in events)) - win.mark
    merged: List[list] = []
    for s, e in sorted((s - offset, e - offset) for n, s, e in events if win.MARKER not in n):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def _overlap(intervals: List[tuple], lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals)


# --------------------------------------------------------------------------- #
# readers of a run record's ``program`` key
# --------------------------------------------------------------------------- #
def _spans(run) -> Optional[List[Dict]]:
    prog = run.get("program")
    return prog["spans"] if prog and prog.get("spans") else None


def _root(spans: List[Dict], i: int) -> Dict:
    while spans[i]["parent"] >= 0:
        i = spans[i]["parent"]
    return spans[i]


def _in_steps(spans: List[Dict], step: str, name: str) -> List[Dict]:
    return [s for i, s in enumerate(spans) if s["name"] == name and _root(spans, i)["name"] == step]


def _device_per_step(run, step: str, names) -> Optional[float]:
    spans = _spans(run)
    if spans is None:
        return None
    steps = [s for s in spans if s["name"] == step]
    inner = [s for n in names for s in _in_steps(spans, step, n)]
    if not steps or not inner or any(s["device_ms"] is None for s in inner):
        return None
    return sum(s["device_ms"] for s in inner) / len(steps)


def fo_mb_host_ms(run) -> Optional[float]:
    """Mean host-clock ms of the window's ``fo.microbatch`` spans: the host's
    time to issue one micro-batch."""
    spans = _spans(run)
    mbs = [s for s in spans or [] if s["name"] == "fo.microbatch"]
    return 1e3 * sum(s["t1"] - s["t0"] for s in mbs) / len(mbs) if mbs else None


def fo_busy_share(run) -> Optional[float]:
    """Device busy time inside the window's ``fo.step`` spans (profiler
    timeline, on the host's clock) over their duration, in %."""
    steps = [s for s in _spans(run) or [] if s["name"] == "fo.step" and "busy_s" in s]
    took = sum(s["t1"] - s["t0"] for s in steps)
    return 100.0 * sum(s["busy_s"] for s in steps) / took if steps and took > 0 else None


def zo_loss_ms(run) -> Optional[float]:
    """``device_ms`` a ZO step in its ``zo.loss`` spans (both evaluations)."""
    return _device_per_step(run, "zo.step", ["zo.loss"])


def zo_pack_ms(run) -> Optional[float]:
    """``device_ms`` a ZO step in ``engine.pack`` and ``engine.unpack``."""
    return _device_per_step(run, "zo.step", ["engine.pack", "engine.unpack"])


def zo_sumsq_calls(run) -> Optional[float]:
    """``engine.sumsq`` counts a ZO step."""
    spans = _spans(run)
    if spans is None:
        return None
    steps = [i for i, s in enumerate(spans) if s["name"] == "zo.step"]
    if not steps:
        return None
    calls = sum(s["counts"].get("engine.sumsq", 0) for i, s in enumerate(spans)
                if _root(spans, i)["name"] == "zo.step")
    return float(calls) / len(steps)


def tail_state_share(run) -> Optional[float]:
    """``device_ms`` in ``ssm.tail_state`` over ``device_ms`` in
    ``model.prefill``, plain-route prefills only, in %."""
    spans = _spans(run)
    if spans is None:
        return None
    plain = {i for i, s in enumerate(spans) if s["name"] == "model.prefill"
             and s["parent"] >= 0 and spans[s["parent"]]["attrs"].get("route") == "plain"}
    tails = [s for s in spans if s["name"] == "ssm.tail_state" and s["parent"] in plain]
    pre = [spans[i] for i in plain]
    if not pre or not tails or any(s["device_ms"] is None for s in pre + tails):
        return None
    whole = sum(s["device_ms"] for s in pre)
    return 100.0 * sum(s["device_ms"] for s in tails) / whole if whole > 0 else None


def decode_issue_ms(run) -> Optional[float]:
    """Mean host-clock ms of the window's ``model.decode`` spans: the host's
    time to issue one decode step."""
    dec = [s for s in _spans(run) or [] if s["name"] == "model.decode"]
    return 1e3 * sum(s["t1"] - s["t0"] for s in dec) / len(dec) if dec else None


#: the readers, by the metric names PERF.md gives them
READERS = {"fo_mb_host_ms.train": fo_mb_host_ms, "fo_busy_share.train": fo_busy_share,
           "zo_loss_ms.train": zo_loss_ms, "zo_pack_ms.train": zo_pack_ms,
           "zo_sumsq_calls.train": zo_sumsq_calls, "tail_state_share.serve": tail_state_share,
           "decode_issue_ms.serve": decode_issue_ms}


def phases(run) -> Dict[str, Dict[str, float]]:
    """Each span name's count, host-clock ms and device ms (None where a span
    has none) over the window, for the breakdown by phase."""
    out: Dict[str, Dict] = {}
    for s in _spans(run) or []:
        rec = out.setdefault(s["name"], {"n": 0, "host_ms": 0.0, "device_ms": 0.0})
        rec["n"] += 1
        rec["host_ms"] += 1e3 * (s["t1"] - s["t0"])
        if s["device_ms"] is None or rec["device_ms"] is None:
            rec["device_ms"] = None
        else:
            rec["device_ms"] += s["device_ms"]
    return out
