"""Serving CLI: offline batch generate or open-loop Poisson traffic.

Counterpart of ``repro.launch.serve``, with its flags:

    python -m repro_torch.launch.serve --arch qwen3-14b --reduce smoke   # on a GPU
    python -m repro_torch.launch.serve --device cpu --arch qwen3-14b --reduce smoke
    python -m repro_torch.launch.serve --device cpu --arch falcon-mamba-7b --reduce smoke
    python -m repro_torch.launch.serve --device cpu --arch qwen3-14b --reduce smoke \
        --traffic poisson:50.0,mixed --requests 16

Offline (default): submit ``--batch`` seeded random prompts to the
continuous-batching engine, print each completion and the measured tokens
per second.

Traffic (``--traffic poisson:RATE[,MIX]``): replay a seeded open-loop
workload (``repro_torch.sim.traffic``) against the engine, price every
scheduler step with the training-side ``ComputeModel`` at
``--flops-per-sec``, and report tokens/sec and p50/p99 TTFT/latency; those
are simulated (the FLOP model's clock), and only the replay's wall time is
measured.  ``--log`` writes one CSV row per request (arrival/ttft/latency),
``--trace`` a Perfetto trace of the replay (one lane per serving slot), and
``main`` returns the replay's ``TrafficResult``.

``--device`` (default ``cuda``, which raises without a GPU) picks the device;
``--use-pallas`` sets ``ModelConfig.use_pallas``, which sends aligned
prefills to the flash-attention kernel (dense decoders) and every prefill on
the card to the selective-scan kernel (SSM decoders, which prefill at exact
length; on the CPU only prompts of a multiple of 64 tokens, the reference's
gate) (default: on for ``cuda``, off for ``cpu``, where the plain path and
the kernel's plain version agree anyway).  With
``--temperature > 0`` the engine's sampling key is the int ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import size_override
from repro_torch.metrics.logging import CSVLogger
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, ServeConfig
from repro_torch.sim.traffic import (
    MIXES,
    TrafficSpec,
    replay,
    replay_seed_sync,
    serve_compute_model,
)


def parse_traffic(arg: str, n_requests: int, seed: int, vocab: int) -> TrafficSpec:
    """``poisson:RATE[,MIX]`` -> TrafficSpec (MIX one of repro_torch.sim.traffic.MIXES)."""
    kind, _, rest = arg.partition(":")
    if kind != "poisson" or not rest:
        raise SystemExit(f"unknown --traffic {arg!r}; want poisson:RATE[,MIX]")
    rate_s, _, mix = rest.partition(",")
    mix = mix or "mixed"
    if mix not in MIXES:
        raise SystemExit(f"unknown traffic mix {mix!r}; have {sorted(MIXES)}")
    return TrafficSpec.from_mix(rate=float(rate_s), n_requests=n_requests,
                                mix=mix, seed=seed, vocab=vocab)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=ARCH_IDS)
    ap.add_argument("--reduce", default="smoke", choices=["full", "100m", "smoke"])
    ap.add_argument("--batch", type=int, default=4,
                    help="offline: number of prompts; traffic: n_requests "
                         "(use --requests to override)")
    ap.add_argument("--requests", type=int, default=None,
                    help="traffic mode: number of arrivals (default --batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8,
                    help="KV-cache slot pool size (max decode batch)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a request when it emits this token (-1 = off)")
    ap.add_argument("--traffic", default=None,
                    help="open-loop workload, e.g. poisson:50.0,mixed")
    ap.add_argument("--flops-per-sec", type=float, default=1e12,
                    help="traffic mode: simulated accelerator throughput")
    ap.add_argument("--log", default=None,
                    help="CSV path for per-request latency rows")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="traffic mode: write a Perfetto trace of the "
                         "replay (one lane per serving slot)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--use-pallas", action=argparse.BooleanOptionalAction, default=None,
                    help="send aligned prefills to the flash-attention kernel "
                         "(dense) and prefills to the selective-scan kernel (SSM) "
                         "(default: on for cuda, off for cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    use_pallas = dev.type == "cuda" if args.use_pallas is None else args.use_pallas
    cfg = size_override(get_config(args.arch), args.reduce).with_(use_pallas=use_pallas)
    if cfg.encoder_only or cfg.frontend != "none":
        raise SystemExit("choose a text decoder arch for serving")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_model(gen, cfg, device=dev)

    if args.traffic:
        return _traffic(args, cfg, params)
    eng = Engine(cfg, params, ServeConfig(
        max_seq=args.prompt_len + args.max_new, temperature=args.temperature,
        eos_id=args.eos_id, slots=args.slots))
    rng = np.random.default_rng(args.seed)
    prompts = [
        list(rng.integers(0, cfg.vocab_size, rng.integers(4, args.prompt_len + 1)))
        for _ in range(args.batch)
    ]
    t0 = time.perf_counter()
    outs = eng.generate(prompts, args.max_new, key=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    fields = ["rid", "prompt_len", "generated", "tokens"]
    with CSVLogger(args.log, fields) as log:
        n_tokens = 0
        for i, o in enumerate(outs):
            gen_toks = o[len(prompts[i]):]
            n_tokens += len(gen_toks)
            print(f"req{i}: prompt_len={len(prompts[i])} -> {gen_toks}")
            log.log(rid=i, prompt_len=len(prompts[i]), generated=len(gen_toks),
                    tokens=" ".join(map(str, gen_toks)))
    print(f"decoded {n_tokens} tokens over {args.slots} slots in {dt:.2f}s "
          f"({n_tokens / dt:.1f} tok/s) on {dev}")



def _traffic(args, cfg, params):
    """The traffic mode: replay, price, log and print; returns the replay's
    ``TrafficResult``."""
    spec = parse_traffic(args.traffic, args.requests or args.batch,
                         args.seed, cfg.vocab_size)
    eng = Engine(cfg, params, ServeConfig(
        max_seq=spec.required_max_seq(), temperature=args.temperature,
        eos_id=args.eos_id, slots=args.slots),
        key=args.seed if args.temperature > 0 else None)
    cm = serve_compute_model(cfg, args.flops_per_sec)
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(clock="sim")
    res = replay(eng, spec, cm, tracer=tracer)
    sync = replay_seed_sync(spec, cm, batch=args.slots)
    fields = ["rid", "arrival", "prompt_len", "max_new", "ttft",
              "queue_s", "service_s", "latency", "finish"]
    with CSVLogger(args.log, fields) as log:
        for row in res.rows:
            log.log(**row)
    if tracer is not None:
        from repro_torch.obs import write_trace
        write_trace(args.trace, tracer, title=f"serve:{args.traffic}")
        print(f"wrote trace {args.trace} ({len(tracer.spans)} spans)")
    s = res.summary
    print(f"traffic {args.traffic}: {int(s['n_requests'])} requests, "
          f"{int(s['total_tokens'])} tokens in {s['makespan_s']:.3f} sim-s "
          f"({s['tok_per_sec']:.1f} tok/s; wall {res.wall_s:.2f}s)")
    print(f"  ttft    p50 {s['p50_ttft_s']*1e3:.1f} ms   "
          f"p99 {s['p99_ttft_s']*1e3:.1f} ms   (queue p99 "
          f"{s['p99_queue_s']*1e3:.1f} ms + service p99 "
          f"{s['p99_service_s']*1e3:.1f} ms)")
    print(f"  latency p50 {s['p50_latency_s']*1e3:.1f} ms   "
          f"p99 {s['p99_latency_s']*1e3:.1f} ms")
    print(f"  seed-sync baseline (batch={args.slots}): "
          f"{sync.summary['tok_per_sec']:.1f} tok/s, "
          f"p99 latency {sync.summary['p99_latency_s']*1e3:.1f} ms")
    return res


if __name__ == "__main__":
    main()
