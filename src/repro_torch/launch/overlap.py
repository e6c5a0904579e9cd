"""How much device work ran while each collective of a step was under way.

Counterpart of ``repro.launch.hlo.async_overlap_stats``, which counts the
instructions its compiler scheduled between each async collective's
``-start`` and ``-done``.  The port has no HLO; its witness is a
``torch.profiler`` trace of a real step.  Every collective of
``dist.collectives`` that runs over the group (``gather_cat`` with the
same-card exchange's copies, ``all_gather``, the gloo all-reduces of
``psum`` / ``pmean``) is one ``record_function`` span named
``collective:<kind>``: a pair, whose gap is the number of kernels that ran
on the card while the span was open and were launched before it began (the
kernels the span launches itself are the collective's own work).  A gap of
0 means the collective had the card to itself: nothing
overlapped it.  Nothing else of ``hlo.py`` is ported: it parses HLO text.

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(...)
    overlap_stats(events_of(prof))
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

PREFIX = "collective:"
#: host calls that put work on the card; a device event's launch is the one
#: with its correlation id
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
             "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperativeKernel")


@dataclass(frozen=True)
class Event:
    """A collective's span (``on_device`` False: host times) or a kernel on
    the card (``on_device`` True: device times, and ``launched`` the host
    time of its launch when known); times in ns on one clock."""
    name: str
    start: float
    end: float
    on_device: bool
    launched: Optional[float] = None


def events_of(prof) -> List[Event]:
    """The collective spans and the card's kernels of a ``torch.profiler``
    profile taken with CPU and CUDA activity."""
    from torch.autograd import DeviceType

    raw = list(prof.profiler.kineto_results.events())
    launch_at = {e.correlation_id(): e.start_ns() for e in raw
                 if e.device_type() == DeviceType.CPU and e.name() in _LAUNCHES}
    out = []
    for e in raw:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CPU and e.name().startswith(PREFIX):
            out.append(Event(e.name(), start, end, False))
        elif e.device_type() == DeviceType.CUDA:
            corr = e.linked_correlation_id() or e.correlation_id()
            out.append(Event(e.name(), start, end, True, launch_at.get(corr)))
    return out


def overlap_stats(events: Iterable[Event]) -> Dict:
    """``{"pairs": N, "overlapped_pairs": M, "by_kind": {kind: count},
    "mean_gap": g, "max_gap": G}`` (the reference's dict): N collective
    spans, M of them with a gap > 0 (the module docstring)."""
    events = list(events)
    kernels = sorted((e for e in events if e.on_device), key=lambda e: e.start)
    gaps, kinds = [], {}
    for c in sorted((e for e in events if not e.on_device and e.name.startswith(PREFIX)),
                    key=lambda e: e.start):
        gaps.append(sum(1 for k in kernels if k.start < c.end and k.end > c.start
                        and not (k.launched is not None and c.start <= k.launched <= c.end)))
        kind = c.name[len(PREFIX):]
        kinds[kind] = kinds.get(kind, 0) + 1
    return {
        "pairs": len(gaps),
        "overlapped_pairs": sum(1 for g in gaps if g > 0),
        "by_kind": kinds,
        "mean_gap": (sum(gaps) / len(gaps)) if gaps else 0.0,
        "max_gap": max(gaps) if gaps else 0,
    }
