"""The port's ``obs`` (a copy of ``repro.obs``) against the reference.

The same spans and counters, recorded through each package's ``Tracer`` in
sim mode (seeded numpy times, lanes, kinds, byte payloads, nesting), give
byte-identical ``dumps`` and written files, equal ``attribution`` (exactly:
the same float sums in the same order) and equal ``format_report`` lines;
the exported JSON round-trips through ``spans_from_events`` in both.  A
wall-clock tracer nests spans on the same stack discipline in both.
"""
import json

import numpy as np
import pytest

from repro import obs as J
from repro_torch import obs as O


def _record(mod, seed: int):
    """A sim-mode tracer with seeded spans (some nested) and counters."""
    rng = np.random.default_rng(seed)
    tr = mod.Tracer(clock="sim")
    lanes = [mod.worker_lane(w) for w in (-1, 0, 1, 2)] + [mod.slot_lane(s) for s in (-1, 3)]
    t = 0.0
    for i in range(40):
        t0 = t + float(rng.exponential(0.01))
        t1 = t0 + float(rng.exponential(0.02))
        kind = mod.KINDS[int(rng.integers(len(mod.KINDS)))]
        parent = int(rng.integers(i)) if i and rng.random() < 0.3 else -1
        tr.add(kind, lanes[int(rng.integers(len(lanes)))], t0, t1,
               name=f"op{i}" if rng.random() < 0.7 else "",
               nbytes=int(rng.integers(0, 1 << 20)), worker=int(rng.integers(-1, 3)),
               src_kind="event" if rng.random() < 0.5 else None, parent=parent)
        tr.counter(t1, "train", "ledger_bytes", float(rng.integers(0, 1 << 30)))
        t = t0
    return tr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dumps_byte_identical(seed):
    jt, tt = _record(J, seed), _record(O, seed)
    for title in ("repro", "train:gemma2-2b"):
        assert (O.dumps(tt.spans, tt.counters, title=title)
                == J.dumps(jt.spans, jt.counters, title=title))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribution_and_report_equal(seed):
    jt, tt = _record(J, seed), _record(O, seed)
    ja, ta = J.attribution(jt.spans), O.attribution(tt.spans)
    assert ta == ja
    assert O.format_report(ta, title="t") == J.format_report(ja, title="t")


@pytest.mark.parametrize("seed", [0, 1])
def test_written_trace_round_trips(tmp_path, seed):
    jt, tt = _record(J, seed), _record(O, seed)
    pj = J.write_trace(str(tmp_path / "j.json"), jt, title="x")
    pt = O.write_trace(str(tmp_path / "t.json"), tt, title="x")
    assert open(pt, "rb").read() == open(pj, "rb").read()
    ev = O.load_trace_events(pt)
    O.validate_trace_events(ev)
    back = O.spans_from_events(ev)
    assert [(s.kind, s.lane, s.name, s.nbytes, s.worker, s.src_kind) for s in back] == [
        (s.kind, s.lane, s.name or s.kind, s.nbytes, s.worker, s.src_kind)
        for s in J.spans_from_events(J.load_trace_events(pj))]
    assert O.attribution_from_file(pt) == J.attribution_from_file(pj)


def test_wall_spans_nest_as_the_reference():
    """Wall clock: each span nests under the one open around it, carries
    the bytes set inside its block, and ends after it starts."""
    out = []
    for mod in (J, O):
        tr = mod.Tracer(clock="wall")
        with tr.span("compute", "train", name="fo/0") as sp:
            with tr.span("checkpoint", "train", name="ckpt_save"):
                pass
            sp.nbytes = 123
        tr.counter(tr.now(), "train", "ledger_bytes", 123)
        doc = json.loads(mod.dumps(tr.spans, tr.counters))
        out.append([(s.kind, s.name, s.nbytes, s.parent, s.t1 >= s.t0) for s in tr.spans]
                   + [[e["ph"] for e in doc["traceEvents"]]])
    assert out[0] == out[1]
    assert out[1][0] == ("compute", "fo/0", 123, -1, True)
    assert out[1][1][3] == 0


def test_bad_span_kind_raises_as_the_reference():
    for mod in (J, O):
        with pytest.raises(AssertionError):
            mod.Span("nonsense", "lane", 0.0, 1.0)
