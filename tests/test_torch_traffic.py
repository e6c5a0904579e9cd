"""The port's open-loop traffic replay (``repro_torch.sim.traffic``) and the
serve CLI's ``--traffic`` mode against the reference's, on the CPU.

* ``poisson_trace``: arrival times bit for bit, the prompts and budgets
  equal, over every mix and a few rates and seeds.
* ``replay`` against the port's ``serving.Engine`` on ``qwen3-14b.reduced()``
  (float32) from the reference's weights (``convert.params_from_numpy``),
  the reference's ``replay`` on its own ``Engine``: with EOS off (``eos_id``
  -1) the events, rows and summary are token-independent and equal exactly,
  on the plain path and with ``use_pallas`` (the mixed mix's 48-token
  prompts take the 64 bucket, the flash kernel's plain version here and the
  Pallas kernel in interpret mode there), with and without per-step
  overheads; with an ``eos_id`` that fires, greedy tokens agree at
  temperature 0 (as in tests/test_torch_serving.py) and so do the events,
  rows and summary.  ``replay_seed_sync`` is equal exactly.
* The sim-clock ``Tracer``'s spans and counters are equal, field by field.
* Both packages' ``launch.serve.main --traffic`` from the same weights: the
  printed summary lines (but the wall time), the CSV and the trace JSON are
  equal, also at temperature > 0 (EOS off: the prices do not depend on the
  tokens).
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as JSV
import repro.sim.traffic as JTR
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.obs import Tracer as JTracer
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as TSV
from repro_torch.models import transformer as T
from repro_torch.obs import Tracer
from repro_torch.serving import Engine, ServeConfig
from repro_torch.sim import traffic as TTR

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def qwen():
    jcfg = jget_config("qwen3-14b").reduced().with_(remat=False)
    jp = JT.init_model(jax.random.key(0), jcfg)
    cfg = get_config("qwen3-14b").reduced().with_(remat=False)
    return jcfg, jp, cfg, params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("mix", sorted(TTR.MIXES))
def test_poisson_trace_equals_reference(mix):
    assert TTR.MIXES == JTR.MIXES
    for rate, n, seed in ((50.0, 32, 0), (300.0, 17, 11), (1e4, 5, 3)):
        spec = TTR.TrafficSpec.from_mix(rate, n, mix=mix, seed=seed, vocab=512)
        jspec = JTR.TrafficSpec.from_mix(rate, n, mix=mix, seed=seed, vocab=512)
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        assert spec.required_max_seq() == jspec.required_max_seq()
        got, want = TTR.poisson_trace(spec), JTR.poisson_trace(jspec)
        assert [dataclasses.astuple(a) for a in got] == [dataclasses.astuple(a) for a in want]
    weighted = dict(rate=80.0, n_requests=20, prompt_lens=(3, 5), prompt_weights=(1.0, 3.0),
                    out_lens=(2, 9, 4), vocab=97, seed=5)
    assert ([dataclasses.astuple(a) for a in TTR.poisson_trace(TTR.TrafficSpec(**weighted))]
            == [dataclasses.astuple(a) for a in JTR.poisson_trace(JTR.TrafficSpec(**weighted))])


def test_compute_model_and_seed_sync_equal_reference(qwen):
    jcfg, _, cfg, _ = qwen
    assert (dataclasses.astuple(TTR.serve_compute_model(cfg, 1e9))
            == dataclasses.astuple(JTR.serve_compute_model(jcfg, 1e9)))
    for mix, batch, oh in (("mixed", 4, (0.0, 0.0)), ("long", 3, (2e-4, 5e-5)),
                           ("short", 1, (1e-3, 0.0))):
        spec = TTR.TrafficSpec.from_mix(200.0, 24, mix=mix, seed=3, vocab=cfg.vocab_size)
        jspec = JTR.TrafficSpec.from_mix(200.0, 24, mix=mix, seed=3, vocab=cfg.vocab_size)
        got = TTR.replay_seed_sync(spec, TTR.serve_compute_model(cfg, 1e9), batch,
                                   TTR.StepOverheads(*oh))
        want = JTR.replay_seed_sync(jspec, JTR.serve_compute_model(jcfg, 1e9), batch,
                                    JTR.StepOverheads(*oh))
        assert (got.events, got.rows, got.summary) == (want.events, want.rows, want.summary)


def both_replays(qwen, spec_kw, slots, use_pallas=False, eos_id=-1, overheads=(0.0, 0.0),
                 trace=False):
    jcfg, jp, cfg, params = qwen
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    spec, jspec = TTR.TrafficSpec(**spec_kw), JTR.TrafficSpec(**spec_kw)
    tr, jtr = (Tracer(clock="sim"), JTracer(clock="sim")) if trace else (None, None)
    eng = Engine(cfg, params, ServeConfig(max_seq=spec.required_max_seq(), slots=slots,
                                          eos_id=eos_id))
    jeng = JEngine(jcfg, jp, JServeConfig(max_seq=jspec.required_max_seq(), slots=slots,
                                          eos_id=eos_id))
    got = TTR.replay(eng, spec, TTR.serve_compute_model(cfg, 1e9), TTR.StepOverheads(*overheads),
                     tracer=tr)
    want = JTR.replay(jeng, jspec, JTR.serve_compute_model(jcfg, 1e9),
                      JTR.StepOverheads(*overheads), tracer=jtr)
    return got, want, eng, jeng, tr, jtr


MIXED = dict(rate=200.0, n_requests=12, prompt_lens=(4, 16, 48), prompt_weights=(2, 1, 1),
             out_lens=(4, 8, 16), out_weights=(1, 2, 1), vocab=512, seed=3)
SHORT = dict(rate=300.0, n_requests=16, prompt_lens=(4, 9, 16), out_lens=(3, 8), vocab=512,
             seed=11)


@pytest.mark.parametrize("spec_kw,slots,use_pallas,overheads", [
    (SHORT, 3, False, (0.0, 0.0)),
    (SHORT, 1, False, (1e-3, 2e-4)),
    (MIXED, 4, True, (0.0, 0.0)),
])
def test_replay_equals_reference_with_eos_off(qwen, spec_kw, slots, use_pallas, overheads):
    got, want, eng, _, _, _ = both_replays(qwen, spec_kw, slots, use_pallas=use_pallas,
                                           overheads=overheads)
    assert got.events == want.events
    assert got.rows == want.rows
    assert got.summary == want.summary
    assert got.summary["total_tokens"] == float(sum(r["max_new"] for r in got.rows))
    if use_pallas:
        assert 64 in eng.scheduler.prefill_buckets()


def test_replay_equals_reference_with_eos_that_fires(qwen):
    """The most frequent greedy token of the EOS-off run becomes the EOS:
    requests retire early, at the same steps in both packages, because the
    greedy tokens agree at temperature 0."""
    off, _, eng, _, _, _ = both_replays(qwen, SHORT, 3)
    toks = [t for rid in range(SHORT["n_requests"])
            for t in eng.result(rid)[len(TTR.poisson_trace(TTR.TrafficSpec(**SHORT))[rid].prompt):]]
    eos = int(np.bincount(toks).argmax())
    got, want, eng, jeng, _, _ = both_replays(qwen, SHORT, 3, eos_id=eos)
    for rid in range(SHORT["n_requests"]):
        assert eng.result(rid) == [int(t) for t in jeng.result(rid)]
    assert got.summary["total_tokens"] < off.summary["total_tokens"]
    assert any(e[0] == "done" and e[2] == "decode" for e in got.events)
    assert (got.events, got.rows, got.summary) == (want.events, want.rows, want.summary)


def test_replay_tracer_equals_reference(qwen):
    got, want, _, _, tr, jtr = both_replays(qwen, SHORT, 3, trace=True)
    assert [dataclasses.astuple(s) for s in tr.spans] == [
        dataclasses.astuple(s) for s in jtr.spans]
    assert tr.counters == jtr.counters and tr.lanes() == jtr.lanes()
    assert {s.kind for s in tr.spans} == {"queue.contention", "prefill", "decode"}
    assert got.events == want.events


def test_replay_refuses_a_used_engine_and_a_short_max_seq(qwen):
    _, _, cfg, params = qwen
    spec = TTR.TrafficSpec(**SHORT)
    cm = TTR.serve_compute_model(cfg)
    with pytest.raises(AssertionError, match="max_seq"):
        TTR.replay(Engine(cfg, params, ServeConfig(max_seq=8, slots=2)), spec, cm)
    eng = Engine(cfg, params, ServeConfig(max_seq=spec.required_max_seq(), slots=2))
    eng.submit([1, 2, 3], 2)
    with pytest.raises(AssertionError, match="fresh engine"):
        TTR.replay(eng, spec, cm)
    with pytest.raises(AssertionError, match="simulated time"):
        TTR.replay(Engine(cfg, params, ServeConfig(max_seq=spec.required_max_seq(), slots=2)),
                   spec, cm, tracer=Tracer(clock="wall"))


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #
def _cli_both(tmp_path, monkeypatch, capsys, extra):
    """Both packages' ``main`` on the same flags and weights: their printed
    lines (the wall time masked), CSVs and trace files."""
    jcfg = JSV.size_override(jget_config("qwen3-14b"), "smoke")
    jp = JT.init_model(jax.random.key(0), jcfg)
    monkeypatch.setattr(T, "init_model", lambda gen, cfg, device: params_from_numpy(
        jax.tree.map(np.asarray, jp), device=device))
    out = {}
    for name, main, dev in (("ref", JSV.main, []), ("port", TSV.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        main(["--arch", "qwen3-14b", "--reduce", "smoke", "--slots", "3", *extra, *dev,
              "--log", str(d / "rows.csv"), "--trace", str(d / "trace.json")])
        lines = capsys.readouterr().out.splitlines()
        out[name] = ([re.sub(r"wall [0-9.]+s", "wall *", ln).replace(str(d), "<dir>")
                      for ln in lines],
                     (d / "rows.csv").read_text(), (d / "trace.json").read_bytes())
    return out["ref"], out["port"]


@pytest.mark.parametrize("extra", [
    ["--traffic", "poisson:50.0,mixed", "--requests", "10"],
    ["--traffic", "poisson:300", "--batch", "6", "--flops-per-sec", "1e9",
     "--temperature", "0.8"],
])
def test_cli_traffic_equals_reference(tmp_path, monkeypatch, capsys, extra):
    (jl, jcsv, jtrace), (tl, tcsv, ttrace) = _cli_both(tmp_path, monkeypatch, capsys, extra)
    assert tl == jl and tcsv == jcsv and ttrace == jtrace
    assert any(ln.startswith("traffic poisson:") for ln in tl)
    assert any("seed-sync baseline" in ln for ln in tl)
    n = 10 if "--requests" in extra else 6
    assert tcsv.count("\n") == n + 1


def test_cli_traffic_refuses_unknown_specs():
    for bad, match in (("uniform:5", "want poisson"), ("poisson:5,huge", "unknown traffic mix")):
        with pytest.raises(SystemExit, match=match):
            TSV.main(["--device", "cpu", "--arch", "qwen3-14b", "--traffic", bad])
