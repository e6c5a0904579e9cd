"""``repro_torch.launch.overlap.overlap_stats`` against the reference's
``repro.launch.hlo.async_overlap_stats``.

A random schedule of collectives (``all-gather``, ``all-reduce``,
``reduce-scatter``) and compute operations is written twice: as HLO text
(``<kind>-start``, the compute lines, ``<kind>-done`` consuming the start)
and as the port's events (a collective's span on the host clock, each
compute operation a kernel on the card inside or outside the spans).  Both
give the same dict.  The port's own rule: a kernel that the span launched
itself is the collective's own work, not overlap.  ``events_of`` reads the
``collective:<kind>`` spans of a CPU profile.
"""
import numpy as np
import pytest
import torch

from repro.launch.hlo import async_overlap_stats
from repro_torch.dist import collectives as coll
from repro_torch.launch.overlap import Event, events_of, overlap_stats

KINDS = ("all-gather", "all-reduce", "reduce-scatter")


def _schedule(seed):
    """[(kind, compute ops inside its span, compute ops after it)]."""
    rng = np.random.default_rng(seed)
    return [(KINDS[rng.integers(3)], int(rng.integers(0, 4)), int(rng.integers(0, 3)))
            for _ in range(int(rng.integers(1, 12)))]


def _hlo(schedule):
    lines, n = ["HloModule m", "ENTRY main {", "  %p0 = f32[8]{0} parameter(0)"], 0
    for i, (kind, inside, after) in enumerate(schedule):
        lines.append(f"  %c{i}-start = f32[8]{{0}} {kind}-start(f32[8]{{0}} %p0)")
        for _ in range(inside):
            lines.append(f"  %op{n} = f32[8]{{0}} add(f32[8]{{0}} %p0, f32[8]{{0}} %p0)")
            n += 1
        lines.append(f"  %c{i}-done = f32[8]{{0}} {kind}-done(%c{i}-start)")
        for _ in range(after):
            lines.append(f"  %op{n} = f32[8]{{0}} multiply(f32[8]{{0}} %p0, f32[8]{{0}} %p0)")
            n += 1
    lines.append("}")
    return "\n".join(lines)


def _events(schedule):
    """Each op one time unit apart; the kernels inside a span were launched
    before it (queued earlier on the card)."""
    events, t = [], 0.0
    for kind, inside, after in schedule:
        start = t
        for _ in range(inside):
            events.append(Event("gemm", t + 0.25, t + 0.75, True, launched=start - 10.0))
            t += 1.0
        events.append(Event(f"collective:{kind}", start, t + 0.9, False))
        t += 1.0
        for _ in range(after):
            events.append(Event("elementwise", t + 0.25, t + 0.75, True, launched=t))
            t += 1.0
    return events


@pytest.mark.parametrize("seed", range(8))
def test_overlap_stats_equal_the_reference(seed):
    schedule = _schedule(seed)
    assert overlap_stats(_events(schedule)) == async_overlap_stats(_hlo(schedule))


def test_a_spans_own_kernels_are_not_overlap():
    span = Event("collective:all-gather", 10.0, 20.0, False)
    own = Event("copy", 12.0, 13.0, True, launched=11.0)       # launched inside the span
    queued = Event("gemm", 9.0, 15.0, True, launched=5.0)       # running when it began
    later = Event("gemm", 21.0, 22.0, True, launched=19.0)
    got = overlap_stats([span, own, queued, later])
    assert got == {"pairs": 1, "overlapped_pairs": 1, "by_kind": {"all-gather": 1},
                   "mean_gap": 1.0, "max_gap": 1}
    assert overlap_stats([span, own]) == {"pairs": 1, "overlapped_pairs": 0,
                                          "by_kind": {"all-gather": 1}, "mean_gap": 0.0,
                                          "max_gap": 0}
    assert overlap_stats([]) == async_overlap_stats("")


def test_events_of_reads_the_collective_spans():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for kind in ("all-gather", "all-reduce", "all-gather"):
            with coll._span(kind):
                torch.ones(4) + 1
    events = events_of(prof)
    assert [e.name for e in events] == ["collective:all-gather", "collective:all-reduce",
                                        "collective:all-gather"]
    assert overlap_stats(events)["by_kind"] == {"all-gather": 2, "all-reduce": 1}
