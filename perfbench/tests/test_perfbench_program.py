"""The program's own spans as the harness reads them (``harness.program``,
``spans.py``), on the CPU: each reader on a hand-made run record (its number,
and None without its spans), idle gaps named on a synthetic device timeline,
and whole tiny runs with the program's tracer active in the window."""
import math

import pytest

import tinybench  # first: it puts the benchmark's folder on the path
import spans as spans_tool
from harness import program
from harness.profile import Spans
from repro_torch import obs

TRAIN, SERVE = "hymba-tiny.train", "mamba-tiny.serve"


def _span(name, t0, t1, parent=-1, device_ms=None, attrs=None, counts=None, **kw):
    return dict(name=name, t0=t0, t1=t1, parent=parent, device_ms=device_ms,
                attrs=attrs or {}, counts=counts or {}, **kw)


def _train_record():
    """Two ZO steps and one FO step of two micro-batches."""
    s = [_span("zo.step", 0.0, 3.0)]                                          # 0
    s += [_span("zo.loss", 0.1, 0.5, 0, 600.0, {"point": 0}),                 # 1
          _span("engine.sumsq", 0.0, 0.1, 0, 640.0, {"caller": "coeff"},
                {"engine.sumsq": 1}),
          _span("engine.perturb", 0.5, 0.6, 0, 20.0),                        # 3
          _span("engine.pack", 0.5, 0.55, 3, 12.0),
          _span("engine.unpack", 0.55, 0.6, 3, 4.0),
          _span("zo.loss", 0.6, 1.0, 0, 700.0, {"point": 1}),
          _span("engine.reconstruct", 1.0, 2.0, 0, 700.0),                   # 7
          _span("engine.sumsq", 1.0, 1.5, 7, 650.0, {"caller": "reconstruct"},
                {"engine.sumsq": 1}),
          _span("engine.unpack", 1.9, 2.0, 7, 4.0)]
    s += [_span("zo.step", 3.0, 6.0)]                                         # 10
    s += [_span("zo.loss", 3.1, 3.5, 10, 500.0), _span("zo.loss", 3.6, 4.0, 10, 900.0),
          _span("engine.sumsq", 3.0, 3.1, 10, 1.0, counts={"engine.sumsq": 1}),
          _span("engine.sumsq", 4.0, 4.5, 10, 1.0, counts={"engine.sumsq": 1}),
          _span("engine.pack", 3.5, 3.55, 10, 10.0)]
    s += [_span("fo.step", 6.0, 10.0, busy_s=1.0)]                            # 16
    s += [_span("fo.microbatch", 6.0, 7.5, 16), _span("fo.microbatch", 7.5, 9.5, 16)]
    return {"program": {"spans": s, "counts": {"engine.sumsq": 4}}}


def _serve_record():
    s = [_span("serve.step", 0.0, 1.0)]                                       # 0
    s += [_span("serve.admit", 0.0, 0.6, 0, 600.0, {"rid": 3, "route": "plain"}),   # 1
          _span("model.prefill", 0.0, 0.5, 1, 500.0),                        # 2
          _span("ssm.tail_state", 0.1, 0.2, 2, 100.0),
          _span("ssm.tail_state", 0.2, 0.3, 2, 150.0),
          _span("serve.admit", 0.6, 0.7, 0, 100.0, {"rid": 4, "route": "kernel"}),  # 5
          _span("model.prefill", 0.6, 0.7, 5, 90.0),
          _span("serve.decode", 0.7, 1.0, 0),                                 # 7
          _span("model.decode", 0.7, 0.79, 7, 100.0),
          _span("serve.step", 1.0, 1.2),                                      # 9
          _span("serve.decode", 1.0, 1.2, 9),
          _span("model.decode", 1.0, 1.11, 10, 100.0)]
    return {"program": {"spans": s, "counts": {}}}


def test_training_readers_on_a_hand_made_record():
    rec = _train_record()
    assert program.fo_mb_host_ms(rec) == pytest.approx(1750.0)
    assert program.fo_busy_share(rec) == pytest.approx(25.0)
    assert program.zo_loss_ms(rec) == pytest.approx((600 + 700 + 500 + 900) / 2)
    assert program.zo_pack_ms(rec) == pytest.approx((12 + 4 + 4 + 10) / 2)
    assert program.zo_sumsq_calls(rec) == 2.0
    assert program.tail_state_share(rec) is None and program.decode_issue_ms(rec) is None


def test_serving_readers_on_a_hand_made_record():
    rec = _serve_record()
    assert program.tail_state_share(rec) == pytest.approx(50.0)     # the plain prefill only
    assert program.decode_issue_ms(rec) == pytest.approx(100.0)
    for name in ("fo_mb_host_ms", "fo_busy_share", "zo_loss_ms", "zo_pack_ms",
                 "zo_sumsq_calls"):
        assert getattr(program, name)(rec) is None


@pytest.mark.parametrize("read", sorted(program.READERS))
def test_every_reader_is_none_without_its_spans(read):
    fn = program.READERS[read]
    assert fn({}) is None and fn({"program": {"spans": [], "counts": {}}}) is None
    rec = _train_record() if read.endswith("train") else _serve_record()
    for s in rec["program"]["spans"]:           # no card: no device times, no busy share
        s["device_ms"] = None
        s.pop("busy_s", None)
    if read in ("zo_loss_ms.train", "zo_pack_ms.train", "tail_state_share.serve",
                "fo_busy_share.train"):
        assert fn(rec) is None
    else:
        assert fn(rec) > 0


class _Event:
    def __init__(self, name, start_s, end_s):
        self._n, self._s, self._e = name, start_s, end_s

    def device_type(self):
        return "DeviceType.CUDA"

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._e - self._s) * 1e9)


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda _self: events})()})()


def _synthetic_window():
    """A window on the host's clock from 10 to 20 s; the profiler's clock
    runs 1000 s ahead (the marker at host 9.9).  The device is busy on
    [10, 12], [13, 17.5] and [19, 19.5]; its gaps are (12, 13), (17.5, 19)
    and (19.5, 20).  The program: an FO step [10, 17] with micro-batches
    [10, 13.4] (a backward [12.2, 13.4] in it) and [13.4, 16.8]; a ZO step
    [17, 19.9] with a loss [17.5, 18.5]; a request queued [5, 19] on its
    own lane."""
    win = program.ProgramWindow(False)
    win.on, win.mark, win.t0, win.t1 = True, 9.9, 10.0, 20.0
    ahead = 1000.0
    win.prof = _Prof([_Event("spin_kernel", 9.9 + ahead, 9.95 + ahead)] +
                     [_Event("k", a + ahead, b + ahead)
                      for a, b in ((10, 12), (13, 17.5), (19, 19.5))])
    tr = obs.Tracer(clock="wall")
    tr._epoch = 5.0                              # the program's clock: host - 5
    fo = tr.add("compute", "program", 5.0, 12.0, name="fo.step")
    mb = tr.add("compute", "program", 5.0, 8.4, name="fo.microbatch", parent=fo)
    tr.add("compute", "program", 7.2, 8.4, name="fo.backward", parent=mb)
    tr.add("compute", "program", 8.4, 11.8, name="fo.microbatch", parent=fo)
    zo = tr.add("compute", "program", 12.0, 14.9, name="zo.step")
    tr.add("compute", "program", 12.5, 13.5, name="zo.loss", parent=zo)
    tr.add("queue.contention", "request/1", 0.0, 14.0, name="serve.queued")
    win.tracer = tr
    harness = Spans()
    harness.add("fo_step", 10.0, 17.2)
    harness.add("zo_step", 17.2, 20.0)
    return win, harness


def test_idle_gaps_carry_the_innermost_program_span():
    win, harness = _synthetic_window()
    summary = win.summary(harness)
    gaps = {name: round(gap, 6) for name, gap in summary["breakdown"]["idle_gaps"]}
    assert gaps == {"fo_step>fo.microbatch>fo.backward": 1.0,   # (12, 13): midpoint 12.5
                    "zo_step>zo.loss": 1.5,                     # (17.5, 19): 18.25
                    "zo_step>zo.step": 0.5}                     # (19.5, 20): no phase
    assert summary["busy_s"] == pytest.approx(7.0)


def test_a_root_spans_busy_share_on_the_shared_clock():
    win, _ = _synthetic_window()
    rec = {"program": win.record()}
    fo, zo = [s for s in rec["program"]["spans"] if s["parent"] == -1 and "busy_s" in s]
    assert (fo["t0"], fo["t1"]) == (10.0, 17.0)
    assert fo["busy_s"] == pytest.approx(6.0) and zo["busy_s"] == pytest.approx(1.0)
    assert program.fo_busy_share(rec) == pytest.approx(100 * 6.0 / 7.0)
    queued = [s for s in rec["program"]["spans"] if s["name"] == "serve.queued"]
    assert "busy_s" not in queued[0]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinybench.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload,seconds", [(TRAIN, 0.01), (SERVE, 1.0)])
def test_a_tiny_run_reads_the_programs_spans(root, workload, seconds):
    line = spans_tool.readings(workload, 2**31 + 11, seconds, device="cpu", root=root)
    assert line["correct"], line["checks"]
    got = {k: v for k, v in line["program"].items() if v is not None}
    if workload == TRAIN:
        # the specs path at m = 1: the plain sum of squares twice a ZO step
        assert got["zo_sumsq_calls.train"] == 2.0
        assert set(got) == {"fo_mb_host_ms.train", "zo_sumsq_calls.train"}   # no card
        assert line["phases"]["fo.microbatch"]["n"] == 2          # grad_accum 2, one FO step
        assert line["counts"] == {"engine.sumsq": 2 * 3}          # three ZO steps (tau 4)
    else:
        assert set(got) == {"decode_issue_ms.serve"}
        assert line["phases"]["serve.admit"]["n"] == line["phases"]["serve.queued"]["n"]
    assert all(math.isfinite(v) and v > 0 for v in got.values())
    assert not obs.tracing()


@pytest.mark.parametrize("workload,seconds", [(TRAIN, 0.3), (SERVE, 1.0)])
def test_the_tracing_cost_run_alternates(root, workload, seconds):
    line = spans_tool.cost(workload, 2**31 + 5, seconds, device="cpu", root=root)
    keys = set(line["n"])
    want = ({"fo_step_ms.on", "zo_step_ms.on"} if workload == TRAIN
            else {"decode_step_ms.on", "decode_step_ms.off"})
    assert want <= keys, keys
    assert not obs.tracing()
