"""Serving CLI, offline mode: generate for a batch of random prompts.

Counterpart of ``repro.launch.serve``'s offline mode, with its flags:

    python -m repro_torch.launch.serve --arch qwen3-14b --reduce smoke   # on a GPU
    python -m repro_torch.launch.serve --device cpu --arch qwen3-14b --reduce smoke
    python -m repro_torch.launch.serve --device cpu --arch falcon-mamba-7b --reduce smoke

It submits ``--batch`` seeded random prompts to the continuous-batching
engine, prints each completion and the measured tokens per second.
``--device`` (default ``cuda``, which raises without a GPU) picks the device;
``--use-pallas`` sets ``ModelConfig.use_pallas``, which sends aligned
prefills to the flash-attention kernel (dense decoders) or the selective-scan
kernel (SSM decoders, which prefill at exact length, so only prompts of a
multiple of 64 tokens reach it) (default: on for ``cuda``, off for ``cpu``,
where the plain path and the kernel's plain version agree anyway).
Traffic mode (``--traffic``, and its ``--requests``, ``--flops-per-sec`` and
``--trace``) is not ported yet (ROADMAP Queue 1 item 13).
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=ARCH_IDS)
    ap.add_argument("--reduce", default="smoke", choices=["full", "100m", "smoke"])
    ap.add_argument("--batch", type=int, default=4, help="number of prompts")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8,
                    help="KV-cache slot pool size (max decode batch)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a request when it emits this token (-1 = off)")
    ap.add_argument("--traffic", default=None,
                    help="open-loop workload (not ported yet)")
    ap.add_argument("--log", default=None,
                    help="CSV path for per-request rows")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--use-pallas", action=argparse.BooleanOptionalAction, default=None,
                    help="send aligned prefills to the flash-attention kernel "
                         "(dense) or the selective-scan kernel (SSM) "
                         "(default: on for cuda, off for cpu)")
    args = ap.parse_args(argv)

    if args.traffic:
        raise SystemExit("--traffic: not yet ported (ROADMAP Queue 1 item 13)")
    dev = resolve_device(args.device)
    use_pallas = dev.type == "cuda" if args.use_pallas is None else args.use_pallas
    cfg = size_override(get_config(args.arch), args.reduce).with_(use_pallas=use_pallas)
    if cfg.encoder_only or cfg.frontend != "none":
        raise SystemExit("choose a text decoder arch for serving")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_model(gen, cfg, device=dev)

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


if __name__ == "__main__":
    main()
