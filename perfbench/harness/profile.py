"""The traced window: the device's timeline from ``torch.profiler`` and the harness's spans.

Only the device's activity is recorded (a step of the trainer runs some
hundred thousand host operations, whose recording would slow the host).  The
harness keeps its own spans on the host clock (``Spans``): one per step,
prefill or decode call.  A short marker kernel at the window's start ties
the two clocks together, so that each idle gap of the device is named by the
span the host was in.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


@contextlib.contextmanager
def patched(obj, name: str, new):
    """``obj.name`` is ``new`` inside the block, and its own value again after."""
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield old
    finally:
        setattr(obj, name, old)


class Spans:
    """``(name, start, end)`` on the host's ``perf_counter``, kept in memory."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end))

    def at(self, t: float) -> str:
        for name, s, e in reversed(self.items):
            if s <= t <= e:
                return name
        return "harness"


def _events(prof) -> List[Tuple[str, float, float]]:
    """``(name, start s, end s)`` of every device activity, on the profiler's clock."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).split(".")[-1] != "CUDA":
            continue
        start = ev.start_ns() * 1e-9 if hasattr(ev, "start_ns") else ev.start_us() * 1e-6
        dur = ev.duration_ns() * 1e-9 if hasattr(ev, "duration_ns") else ev.duration_us() * 1e-6
        if dur > 0:
            out.append((ev.name(), start, start + dur))
    return out


class Window:
    """``with Window(on) as w:`` profiles the device in the block when ``on``;
    ``w.summary(spans)`` reads it afterwards."""

    MARKER = "spin_kernel"

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.t0 = self.t1 = self.mark = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize()
            self.mark = time.perf_counter()
            torch.cuda._sleep(20000)
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self, spans: Spans, top: int = 10) -> Optional[Dict]:
        """``busy_s``, ``window_s``, device time by kernel name, and the
        longest idle gaps named by the host's span; None when the profiler
        saw no device activity."""
        if self.prof is None:
            return None
        events = _events(self.prof)
        marks = [s for n, s, _ in events if self.MARKER in n]
        if not events:
            return None
        offset = (marks[0] if marks else min(s for _, s, _ in events)) - self.mark
        lo, hi = self.t0 + offset, self.t1 + offset
        inside = sorted((n, max(s, lo), min(e, hi)) for n, s, e in events
                        if e > lo and s < hi and self.MARKER not in n)
        by_name: Dict[str, List[float]] = {}
        for n, s, e in inside:
            rec = by_name.setdefault(n, [0.0, 0])
            rec[0] += e - s
            rec[1] += 1
        busy, gaps, cur = 0.0, [], lo
        for _, s, e in sorted(inside, key=lambda r: r[1]):
            if s > cur:
                gaps.append((s - cur, cur))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if hi > cur:
            gaps.append((hi - cur, cur))
        gaps.sort(reverse=True)
        named = [[spans.at(start + gap / 2 - offset), gap] for gap, start in gaps[:top]]
        ops = sorted(([n[:120], v[0]] for n, v in by_name.items()), key=lambda r: -r[1])
        return {"busy_s": busy, "window_s": self.t1 - self.t0, "kernels": by_name,
                "breakdown": {"device_ops": ops[:top], "idle_gaps": named}}


class DeviceTimer:
    """CUDA events around each call of a function, summed after the window."""

    def __init__(self):
        self.pairs = []

    def wrap(self, fn):
        def timed(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.pairs.append((s, e))
            return out
        return timed

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)
