"""Open-loop traffic model: serving on the same time-to-X axis as training.

Counterpart of ``repro.sim.traffic``, a copy that drives the port's
``serving.Engine`` (on whatever device its parameters are).  The makespan,
tokens per second and TTFT it reports are simulated: each step is priced by
the FLOP model at ``ComputeModel.flops_per_sec``, never by the device's
clock; only ``TrafficResult.wall_s`` is a host wall time.

Seeded Poisson arrivals with prompt/output-length mixes are replayed against
the REAL continuous-batching scheduler (``repro_torch.serving``): the scheduler
generates actual tokens, and this module prices each scheduler step with the
training-side ``ComputeModel`` — a prefill costs the bucket's tokens of
forward FLOPs, a decode step costs one forward token per live slot — so
"train with HO-SGD, serve the result" reads off one frontier in the same
cost vocabulary (tokens/sec and p50/p99 TTFT/latency vs simulated seconds).

Open loop: arrivals never wait for service — a saturated pool grows the
queue and the latency tail, it doesn't thin the arrival process.

Determinism contract (same as ``repro_torch.sim``): same ``TrafficSpec`` seed ⇒
bit-identical event trace, per-request latency table and summary.  All
randomness (inter-arrival gaps, length draws, prompt tokens) comes from one
``np.random.default_rng(seed)``; simulated time is pure arithmetic over it.

``replay_seed_sync`` prices the seed engine's synchronous batch path (left-
padded rectangle, no early exit, next batch waits for the previous) on the
same trace — the baseline ``benchmarks/serve_bench.py`` compares against.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.costs import ComputeModel, config_fwd_flops

#: named prompt/output-length mixes for the CLI / benchmarks
MIXES: Dict[str, Dict[str, Tuple[int, ...]]] = {
    "short": dict(prompt_lens=(4, 8, 12), prompt_weights=(1, 1, 1),
                  out_lens=(8, 16), out_weights=(1, 1)),
    "mixed": dict(prompt_lens=(4, 16, 48), prompt_weights=(2, 1, 1),
                  out_lens=(4, 16, 32), out_weights=(1, 2, 1)),
    "long": dict(prompt_lens=(32, 96), prompt_weights=(1, 1),
                 out_lens=(32, 64), out_weights=(1, 1)),
}


@dataclass(frozen=True)
class TrafficSpec:
    """Open-loop workload: Poisson(rate) arrivals of mixed-shape requests."""

    rate: float                             # mean arrivals per simulated sec
    n_requests: int
    prompt_lens: Tuple[int, ...] = (4, 16, 48)
    prompt_weights: Optional[Tuple[float, ...]] = None
    out_lens: Tuple[int, ...] = (4, 16, 32)
    out_weights: Optional[Tuple[float, ...]] = None
    vocab: int = 512                        # prompt tokens ~ U[0, vocab)
    seed: int = 0

    def required_max_seq(self) -> int:
        return max(self.prompt_lens) + max(self.out_lens)

    @staticmethod
    def from_mix(rate: float, n_requests: int, mix: str = "mixed",
                 seed: int = 0, vocab: int = 512) -> "TrafficSpec":
        return TrafficSpec(rate=rate, n_requests=n_requests, seed=seed,
                           vocab=vocab, **MIXES[mix])


@dataclass(frozen=True)
class Arrival:
    t: float
    prompt: Tuple[int, ...]
    max_new: int


@dataclass
class TrafficResult:
    events: List[Tuple]                     # deterministic event trace
    rows: List[Dict]                        # per-request latency table
    summary: Dict[str, float]
    wall_s: float = 0.0                     # host wall clock, NOT deterministic


def _norm(weights, n) -> np.ndarray:
    w = np.ones(n, float) if weights is None else np.asarray(weights, float)
    return w / w.sum()


def poisson_trace(spec: TrafficSpec) -> List[Arrival]:
    """Seeded arrival trace: exponential gaps, weighted length mixes."""
    assert spec.rate > 0 and spec.n_requests >= 1
    rng = np.random.default_rng(spec.seed)
    gaps = rng.exponential(1.0 / spec.rate, spec.n_requests)
    times = np.cumsum(gaps)
    p_lens = rng.choice(np.asarray(spec.prompt_lens), spec.n_requests,
                        p=_norm(spec.prompt_weights, len(spec.prompt_lens)))
    o_lens = rng.choice(np.asarray(spec.out_lens), spec.n_requests,
                        p=_norm(spec.out_weights, len(spec.out_lens)))
    return [
        Arrival(float(times[i]),
                tuple(int(t) for t in rng.integers(0, spec.vocab, int(p_lens[i]))),
                int(o_lens[i]))
        for i in range(spec.n_requests)
    ]


def serve_compute_model(cfg, flops_per_sec: float = 1e12) -> ComputeModel:
    """Per-TOKEN forward-FLOP unit: ``time(fevals=k)`` prices k token
    forwards, so prefill = bucket tokens and decode = live slots."""
    return ComputeModel(fwd_flops=config_fwd_flops(cfg, 1, 1),
                        flops_per_sec=flops_per_sec)


@dataclass(frozen=True)
class StepOverheads:
    """Per-step fixed serving overheads.

    ``dispatch_s`` is charged once per priced program launch — each prefill
    bucket and each decode step (host-side dispatch, argument staging);
    ``sample_s`` once per decode step (sampling + detokenize host work).
    Both are fixed per STEP, not per token, which is what makes the slots
    axis price batching amortization: a decode step over ``live`` slots
    spreads the same overhead across ``live`` tokens, so tokens/sec now
    rises with slot count instead of being FLOP-flat.  Both replay paths
    (continuous and the seed synchronous batch) charge the identical
    discipline, so the comparison stays fair; the zero default keeps every
    pre-overhead pin bit-identical.
    """

    dispatch_s: float = 0.0
    sample_s: float = 0.0

    def __post_init__(self):
        assert self.dispatch_s >= 0.0 and self.sample_s >= 0.0

    @property
    def decode_s(self) -> float:
        return self.dispatch_s + self.sample_s


#: the zero-overhead default (pure-FLOP pricing, the pre-overhead contract)
NO_OVERHEADS = StepOverheads()


def _percentile(vals: Sequence[float], q: float) -> float:
    """Deterministic nearest-rank percentile (no interpolation)."""
    s = sorted(vals)
    if not s:
        return 0.0
    k = max(1, int(np.ceil(q * len(s)))) - 1
    return float(s[k])


def _ttft_percentiles(rows: Sequence[Dict]) -> Dict[str, float]:
    """The shared latency-percentile block, with TTFT decomposed into its
    queueing (arrival → admission) and service (admission → first token)
    components — per-row ``ttft == queue_s + service_s`` exactly."""
    out = {}
    for key, col in (("ttft", "ttft"), ("latency", "latency"),
                     ("queue", "queue_s"), ("service", "service_s")):
        vals = [r[col] for r in rows]
        out[f"p50_{key}_s"] = _percentile(vals, 0.50)
        out[f"p99_{key}_s"] = _percentile(vals, 0.99)
    return out


def replay(engine, spec: TrafficSpec, compute: ComputeModel,
           overheads: StepOverheads = NO_OVERHEADS,
           tracer=None) -> TrafficResult:
    """Drive a fresh ``serving.Engine`` open-loop under ``spec``, pricing
    every scheduler step with ``compute`` plus the per-step fixed
    ``overheads`` (dispatch per launch, sampling per decode step).  Returns
    the event trace, the per-request latency table and summary statistics.

    ``tracer`` (a sim-clock ``repro_torch.obs.Tracer``) additionally records each
    request's lifecycle on its admission slot's lane — ``queue.contention``
    (arrival → admission), ``prefill`` (admission → first token), ``decode``
    (first token → retire) — plus a live-slot counter per decode step; the
    spans are stamped from the SAME clock the pricing advances, so tracing
    never perturbs the deterministic events/rows/summary.
    """
    import time as _time

    assert engine.sc.max_seq >= spec.required_max_seq(), \
        "engine max_seq too small for the traffic mix"
    assert not engine.has_work, "replay needs a fresh engine"
    if tracer is not None:
        assert tracer.clock == "sim", "traffic replay stamps simulated time"
    t_wall = _time.perf_counter()
    arrivals = poisson_trace(spec)
    n = len(arrivals)
    events: List[Tuple] = []
    arrival_t: Dict[int, float] = {}
    prompt_len: Dict[int, int] = {}
    budget: Dict[int, int] = {}
    ttft: Dict[int, float] = {}
    queue_s: Dict[int, float] = {}
    done: Dict[int, float] = {}
    lane: Dict[int, str] = {}
    first_tok: Dict[int, float] = {}
    total_tokens = 0
    clock = 0.0
    i = 0
    while len(done) < n:
        while i < n and arrivals[i].t <= clock:
            a = arrivals[i]
            rid = engine.submit(list(a.prompt), a.max_new)
            arrival_t[rid] = a.t
            prompt_len[rid] = len(a.prompt)
            budget[rid] = a.max_new
            events.append(("arrive", rid, a.t))
            i += 1
        if not engine.has_work:
            clock = arrivals[i].t    # idle: jump to the next arrival
            continue
        rep = engine.step()
        prefill_clock: Dict[int, float] = {}
        for rid, L, bucket, slot in rep.admitted:
            admit = clock
            clock += compute.time(fevals=bucket, gevals=0) + overheads.dispatch_s
            prefill_clock[rid] = clock
            ttft[rid] = clock - arrival_t[rid]
            queue_s[rid] = admit - arrival_t[rid]
            events.append(("prefill", rid, L, bucket, clock))
            if tracer is not None:
                from repro_torch.obs.trace import slot_lane
                lane[rid] = slot_lane(slot)
                first_tok[rid] = clock
                tracer.add("queue.contention", lane[rid], arrival_t[rid],
                           admit, name=f"queue/r{rid}")
                tracer.add("prefill", lane[rid], admit, clock,
                           name=f"prefill/{bucket}")
        if rep.live:
            clock += (compute.time(fevals=rep.live, gevals=0)
                      + overheads.dispatch_s + overheads.sample_s)
            events.append(("decode", rep.live, len(rep.emitted), clock))
            if tracer is not None:
                tracer.counter(clock, "slots", "live_slots", rep.live)
        total_tokens += len(rep.emitted)
        for rid, phase in rep.finished:
            t_done = prefill_clock[rid] if phase == "prefill" else clock
            done[rid] = t_done
            events.append(("done", rid, phase, t_done))
            if tracer is not None and phase == "decode":
                tracer.add("decode", lane[rid], first_tok[rid], t_done,
                           name=f"decode/r{rid}")
    rows = [
        dict(rid=rid, arrival=arrival_t[rid], prompt_len=prompt_len[rid],
             max_new=budget[rid], ttft=ttft[rid], queue_s=queue_s[rid],
             service_s=ttft[rid] - queue_s[rid],
             latency=done[rid] - arrival_t[rid], finish=done[rid])
        for rid in sorted(done)
    ]
    makespan = clock
    summary = dict(
        n_requests=float(n),
        total_tokens=float(total_tokens),
        makespan_s=makespan,
        tok_per_sec=total_tokens / makespan if makespan > 0 else 0.0,
        **_ttft_percentiles(rows),
    )
    return TrafficResult(events, rows, summary,
                         wall_s=_time.perf_counter() - t_wall)


def replay_seed_sync(spec: TrafficSpec, compute: ComputeModel,
                     batch: int,
                     overheads: StepOverheads = NO_OVERHEADS) -> TrafficResult:
    """Price the SEED synchronous batch path on the same arrival trace.

    Semantics of the seed ``Engine.generate`` under an offline caller that
    groups arrivals FIFO into fixed batches: a batch starts once the
    previous finished AND its last request arrived; prefill pays the
    left-padded ``B × Lmax`` rectangle; decode pays ``B`` tokens per step
    for ``max(max_new) - 1`` steps (no EOS, no early retirement — every
    request is carried to the rectangle's end, only its own ``max_new``
    tokens count as useful).  Per-step ``overheads`` follow the same
    discipline as ``replay``: dispatch per launch, sampling per decode
    step.  Pricing-only: token values cannot change the seed path's cost,
    so nothing is generated.
    """
    assert batch >= 1
    arrivals = poisson_trace(spec)
    events: List[Tuple] = []
    rows: List[Dict] = []
    clock = 0.0
    total_tokens = 0
    for g0 in range(0, len(arrivals), batch):
        group = arrivals[g0:g0 + batch]
        B = len(group)
        ready = max(a.t for a in group)
        start = max(clock, ready)
        l_max = max(len(a.prompt) for a in group)
        steps = max(a.max_new for a in group)
        first = start + compute.time(fevals=B * l_max, gevals=0) \
            + overheads.dispatch_s
        finish = first + (steps - 1) * (compute.time(fevals=B, gevals=0)
                                        + overheads.dispatch_s
                                        + overheads.sample_s)
        events.append(("batch", g0 // batch, B, l_max, steps, start, finish))
        for j, a in enumerate(group):
            rid = g0 + j
            rows.append(dict(rid=rid, arrival=a.t, prompt_len=len(a.prompt),
                             max_new=a.max_new, ttft=first - a.t,
                             queue_s=start - a.t, service_s=first - start,
                             latency=finish - a.t, finish=finish))
            total_tokens += a.max_new
        clock = finish
    summary = dict(
        n_requests=float(len(arrivals)),
        total_tokens=float(total_tokens),
        makespan_s=clock,
        tok_per_sec=total_tokens / clock if clock > 0 else 0.0,
        **_ttft_percentiles(rows),
    )
    return TrafficResult(events, rows, summary)
