"""The port's own spans and counts (``repro_torch.obs.span`` / ``count``) at
its layer boundaries, on the CPU at a tiny size.

* One ``grad_accum=2`` FO step: one ``fo.step`` holding two
  ``fo.microbatch`` (each ``fo.forward``, ``fo.backward``,
  ``fo.accumulate``), then ``fo.exchange`` and ``fo.update``.
* A ``flat`` ZO step on the specs path, as ``make_distributed_ho_sgd``
  builds it from the model's config (m = 1): two ``zo.loss`` (points 0 and
  1), ``engine.sumsq`` counted twice (callers ``coeff`` and
  ``reconstruct``), ``engine.pack`` / ``engine.unpack``, ``zo.exchange``,
  ``zo.update``.  Without specs the fused flat round gives
  ``engine.perturb_sumsq`` and ``engine.reconstruct_update``.
* Serving a tiny SSM model: one ``serve.admit`` and one ``serve.queued``
  per request with the same ``rid``; one ``ssm.tail_state`` per SSM layer
  of a plain prefill and none on the kernel's route.
* With no active tracer ``obs.span`` is one shared no-op and nothing is
  recorded; a step's losses and parameters are the same bits with the
  tracer on or off.
"""
import contextlib
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.distributed import make_distributed_ho_sgd
from repro_torch.core.ho_sgd import HOSGDConfig
from repro_torch.launch.mesh import make_test_mesh, process_group
from repro_torch.models import transformer as T
from repro_torch.opt.optimizers import const_schedule, sgd
from repro_torch.serving import Engine, ServeConfig
from repro_torch.tree import tree_leaves

HYBRID = get_config("hymba-1.5b").reduced().with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
    grad_accum=2)
SSM = get_config("falcon-mamba-7b").reduced().with_(n_layers=3, d_model=64, vocab_size=128)


def _batch(seed: int, B: int = 4, S: int = 16):
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, HYBRID.vocab_size, (B, S + 1)))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _trainer(specs: bool):
    """``(fo, zo, params, opt_state)`` of a one-process flat-engine trainer
    (m = 1), with the parameter specs as the benchmark's trainer has them
    when ``specs``, else without (the fused flat round)."""
    cfg = HYBRID
    params = T.init_model(0, cfg, device="cpu")
    mesh = make_test_mesh(data=1, model=1, device="cpu")
    ho = HOSGDConfig(tau=4, mu=1e-2, m=1, lr=1e-2, zo_lr=1e-4, seed=3, engine="flat")
    opt = sgd(const_schedule(ho.lr))
    loss_fn = lambda p, b: T.loss_fn(cfg, p, b)  # noqa: E731
    kw = dict(model_cfg=cfg, params_like=params) if specs else {}
    fo, zo = make_distributed_ho_sgd(loss_fn, mesh, ho, opt, **kw)
    return fo, zo, params, opt.init(params)


def _children(tr: obs.Tracer, idx: int):
    return [s.name for s in tr.spans if s.parent == idx]


def _named(tr: obs.Tracer, name: str):
    return [(i, s) for i, s in enumerate(tr.spans) if s.name == name]


def test_fo_step_spans_by_phase():
    with process_group():
        fo, _, params, state = _trainer(specs=True)
        with obs.active(obs.Tracer(clock="wall")) as tr:
            fo(0, params, state, _batch(0))
    ((root, step),) = _named(tr, "fo.step")
    assert step.parent == -1 and step.attrs == {"t": 0}
    assert _children(tr, root) == ["fo.microbatch", "fo.microbatch", "fo.exchange", "fo.update"]
    mbs = _named(tr, "fo.microbatch")
    assert [s.attrs["i"] for _, s in mbs] == [0, 1]
    for idx, _ in mbs:
        assert _children(tr, idx) == ["fo.forward", "fo.backward", "fo.accumulate"]
    assert all(s.device_ms is None for s in tr.spans)      # no card here
    assert all(s.t1 >= s.t0 for s in tr.spans)


def test_zo_step_on_the_specs_path_counts_two_sums_of_squares():
    with process_group():
        _, zo, params, state = _trainer(specs=True)
        with obs.active(obs.Tracer(clock="wall")) as tr:
            zo(1, params, state, _batch(1))
    ((root, _),) = _named(tr, "zo.step")
    loss = [s for _, s in _named(tr, "zo.loss")]
    assert [(s.attrs["point"], s.attrs["worker"]) for s in loss] == [(0, 0), (1, 0)]
    sums = [s for _, s in _named(tr, "engine.sumsq")]
    assert [s.attrs["caller"] for s in sums] == ["coeff", "reconstruct"]
    assert [s.counts for s in sums] == [{"engine.sumsq": 1}] * 2
    assert tr.totals == {"engine.sumsq": 2}
    names = {s.name for s in tr.spans}
    assert {"engine.pack", "engine.unpack", "engine.perturb", "engine.reconstruct",
            "zo.exchange", "zo.update"} <= names
    assert "engine.perturb_sumsq" not in names
    # every program span of the step lies inside it
    assert all(s.parent >= 0 for i, s in enumerate(tr.spans) if i != root)
    # the counter samples the running total
    assert [v for _, _, n, v in tr.counters if n == "engine.sumsq"] == [1.0, 2.0]


def test_fused_flat_round_spans():
    with process_group():
        _, zo, params, state = _trainer(specs=False)
        with obs.active(obs.Tracer(clock="wall")) as tr:
            zo(1, params, state, _batch(1))
    names = [s.name for s in tr.spans]
    assert names.count("engine.perturb_sumsq") == 1
    assert names.count("engine.reconstruct_update") == 1
    assert names.count("zo.loss") == 2
    assert "engine.sumsq" not in names and "engine.sumsq" not in tr.totals


def test_serving_spans_per_request_and_per_layer():
    cfg = SSM.with_(use_pallas=True)       # the kernel's route at multiples of 64
    params = T.init_model(1, cfg, device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_seq=80, slots=2, temperature=0.0))
    lens = [9, 64, 13]
    rng = np.random.default_rng(2)
    with obs.active(obs.Tracer(clock="wall")) as tr:
        rids = [eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(), 3) for n in lens]
        while eng.has_work:
            eng.step()
    admits = [(i, s) for i, s in _named(tr, "serve.admit")]
    assert [s.attrs["rid"] for _, s in admits] == rids
    assert [s.attrs["tokens"] for _, s in admits] == lens
    assert [s.attrs["route"] for _, s in admits] == ["plain", "kernel", "plain"]
    queued = [s for _, s in _named(tr, "serve.queued")]
    assert sorted(s.attrs["rid"] for s in queued) == rids
    assert all(s.lane == f"request/{s.attrs['rid']}" and s.parent == -1 for s in queued)
    for idx, s in admits:
        assert _children(tr, idx) == ["model.prefill", "serve.sample", "cache.assign"]
        (pre,) = [j for j, c in enumerate(tr.spans) if c.parent == idx
                  and c.name == "model.prefill"]
        tails = _children(tr, pre).count("ssm.tail_state")
        assert tails == (cfg.n_layers if s.attrs["route"] == "plain" else 0)
    assert all(s.parent >= 0 for s in tr.spans if s.name != "serve.step"
               and s.name != "serve.queued")
    decodes = _named(tr, "serve.decode")
    assert decodes and all(_children(tr, i) == ["model.decode", "serve.sample"]
                           for i, _ in decodes)
    # the exporter carries the attributes; the round trip gives them back
    doc = json.loads(obs.dumps(tr.spans, tr.counters))
    admit_ev = [e for e in doc["traceEvents"] if e.get("name") == "serve.admit"]
    assert [e["args"]["attrs"]["rid"] for e in admit_ev] == rids
    back = obs.spans_from_events(doc["traceEvents"])
    assert [s.attrs for s in back] == [s.attrs for s in tr.spans]


def test_off_path_is_one_shared_no_op():
    assert not obs.tracing()
    a, b = obs.span("fo.step", t=1), obs.span("serve.admit", kind="prefill", rid=2)
    assert a is b is obs.NO_SPAN
    with a as sp:
        assert sp is None
    obs.count("engine.sumsq")
    obs.interval("serve.queued", 0.0, "request/0")
    with process_group():
        fo, _, params, state = _trainer(specs=True)
        tr = obs.Tracer(clock="wall")
        fo(0, params, state, _batch(0))
    assert tr.spans == [] and tr.counters == [] and tr.totals == {}


def test_activation_rules():
    tr = obs.Tracer(clock="wall")
    with obs.active(tr):
        assert obs.tracing()
        with pytest.raises(RuntimeError):
            obs.activate(obs.Tracer(clock="wall"))
    assert not obs.tracing() and obs.deactivate() is None
    with pytest.raises(ValueError):
        obs.activate(obs.Tracer(clock="sim"))
    assert not obs.tracing()
    assert obs.Tracer(clock="wall", device=True).device is torch.cuda.is_available()
    assert not obs.Tracer(clock="sim", device=True).device


def test_tracer_on_or_off_gives_the_same_bits():
    """An FO step and two ZO steps (the specs path and the fused round)."""
    runs = []
    for on in (False, True):
        out = []
        with process_group():
            for specs in (True, False):
                fo, zo, params, state = _trainer(specs)
                tr = obs.Tracer(clock="wall")
                with obs.active(tr) if on else contextlib.nullcontext():
                    params, state, f_loss = fo(0, params, state, _batch(0))
                    params, state, z_loss = zo(1, params, state, _batch(1))
                out.append((f_loss, z_loss, [x.clone() for x in tree_leaves(params)]))
                assert bool(tr.spans) is on
        runs.append(out)
    for (fa, za, pa), (fb, zb, pb) in zip(*runs):
        assert torch.equal(fa, fb) and torch.equal(za, zb)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_interval_is_stamped_from_perf_counter():
    tr = obs.Tracer(clock="wall")
    start = time.perf_counter()
    with obs.active(tr):
        obs.interval("serve.queued", start, "request/7", kind="queue.contention", rid=7)
    (s,) = tr.spans
    assert abs((s.t0 + tr.epoch) - start) < 1e-9 and s.t1 >= s.t0
    assert s.attrs == {"rid": 7} and s.kind == "queue.contention"
