"""A cell's run with the program's own spans recorded, on the chip, in one process.

    python3 perfbench/spans.py --workload <name> --seed <n> [--seconds 51] \\
        [--cost 0|1] [--trace-out chiprun_out/spans.json]

With ``--cost 0`` (the default): one traced run of the cell (as ``run.py
--trace 1`` makes it: the profiler, the harness's own timers), with a
``repro_torch.obs`` tracer active for the window (``harness.program``).  One
JSON line: the cell's ``correct`` and checks; the readings of the program's
spans (``harness.program.READERS``) beside the cell's per-layer metrics in
the same run; each span name's count, host ms and device ms
(``phases``); the idle gaps named by the harness's span and the program's
(``breakdown``); the plain sum of squares' device ms a ZO step by
``engine.sumsq``'s events beside the harness's ``DeviceTimer``.  With
``--trace-out`` the program's spans go to a Perfetto file too.

With ``--cost 1``: one untraced run (no profiler, no harness timers) in
which the tracer is active over alternate parts of the window in the order
on, off, off, on, on, off, ...: a training cell's periods of ``tau`` steps
(its steps' host seconds, as ``fo_step_ms.train`` and ``zo_step_ms.train``
read them), a serving cell's scheduler steps (each decode call's seconds,
synchronised before and after, as ``decode_step_ms.serve`` reads it).  One
JSON line: each such time with the tracer on and off.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def _device(device: str):
    import torch

    if device == "cuda":
        from repro_torch.device import resolve_device

        return resolve_device("cuda:0")
    return torch.device(device)


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             root: Path = ROOT, trace_out: str = None) -> dict:
    """One traced run of the cell with the program's tracer active in the window."""
    import importlib

    from harness import manifest, program, runner
    from harness.profile import patched

    cell = manifest.cell(root, workload)
    kind = importlib.import_module(f"harness.{cell.traffic['kind']}")
    windows = []

    def window(on):
        windows.append(program.ProgramWindow(on))
        return windows[-1]

    ctx = runner.Context(cell, seed, seconds, True, _device(device), time.perf_counter())
    with patched(kind, "Window", window):
        rec = kind.run(ctx)
    win = windows[-1]
    rec["program"] = win.record()
    checks = {name: [rec["numbers"].get(name, math.nan), spec["limit"]]
              for name, spec in cell.limits.items()}
    line = {"workload": workload, "seed": seed,
            "correct": bool(checks) and all(math.isfinite(v) and v <= lim
                                            for v, lim in checks.values()),
            "checks": checks, "window_s": rec["window_s"],
            "program": {name: read(rec) for name, read in program.READERS.items()},
            "harness": {m["name"]: manifest.reader(root, m["name"])(rec)
                        for m in cell.per_layer},
            "phases": program.phases(rec), "counts": rec["program"]["counts"]}
    if rec.get("trace"):
        line["breakdown"] = rec["trace"]["breakdown"]
        line["busy_s"] = rec["trace"]["busy_s"]
    zo = [s for s in rec.get("steps", []) if s["order"] == "zo_step"]
    if zo and rec.get("sumsq_ms") is not None:
        sums = [s for s in rec["program"]["spans"] if s["name"] == "engine.sumsq"]
        line["sumsq_ms_per_zo_step"] = {
            "engine.sumsq": (sum(s["device_ms"] for s in sums) / len(zo)
                             if sums and all(s["device_ms"] is not None for s in sums)
                             else None),
            "DeviceTimer": rec["sumsq_ms"] / len(zo)}
    if trace_out:
        from repro_torch import obs

        obs.write_trace(trace_out, win.tracer, title=f"perfbench:{workload}")
    return line


def _on(k: int) -> bool:
    """On, off, off, on, on, off, off, on, ...: each part's order alternated."""
    return k % 4 in (0, 3)


def cost(workload: str, seed: int, seconds: float, device: str = "cuda",
         root: Path = ROOT) -> dict:
    """One untraced run with the tracer active over alternate parts of the window."""
    import torch

    from harness import manifest, runner
    from harness.profile import patched
    from repro_torch import obs

    cell = manifest.cell(root, workload)
    dev = _device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ctx = runner.Context(cell, seed, seconds, False, dev, time.perf_counter())

    def traced(on: bool):
        return (obs.active(obs.Tracer(clock="wall", device=dev.type == "cuda")) if on
                else contextlib.nullcontext())

    if cell.traffic["kind"] == "train":
        from harness import train
        from repro_torch.core import distributed

        make, tau, n_setup = (distributed.make_distributed_ho_sgd, cell.traffic["tau"],
                              cell.traffic["setup_steps"])
        flags = {}

        def wrapped(*a, **kw):
            def wrap(step):
                def run(t, *args):
                    on = t >= n_setup and _on((t - n_setup) // tau)
                    flags[t] = on
                    with traced(on):
                        return step(t, *args)
                return run
            return tuple(wrap(s) for s in make(*a, **kw))

        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(distributed, "make_distributed_ho_sgd", wrapped))
            rec = train.run(ctx)
        times = {}
        for s in rec["steps"]:
            key = f"{s['order']}_ms.{'on' if flags[s['t']] else 'off'}"
            times.setdefault(key, []).append(1e3 * s["s"])
    else:
        from harness import serve
        from repro_torch.models import transformer as T
        from repro_torch.serving import scheduler

        state = {"k": 0, "on": False, "live": False}
        times = {}
        step, decode = scheduler.Scheduler.step, T.decode_step_slots

        def stepped(self):
            state["k"] += 1
            state["on"] = state["live"] and _on(state["k"])
            with traced(state["on"]):
                return step(self)

        def timed(*a, **kw):
            sync()
            s = time.perf_counter()
            out = decode(*a, **kw)
            sync()
            if state["live"]:
                key = f"decode_step_ms.{'on' if state['on'] else 'off'}"
                times.setdefault(key, []).append(1e3 * (time.perf_counter() - s))
            return out

        submit = scheduler.Scheduler.submit

        def submitted(self, *a, **kw):       # the window's requests start the count
            if not state["live"] and len(self.requests) >= len(cell.traffic.get(
                    "warmup_prompt_lens", [])):
                state["live"] = True
            return submit(self, *a, **kw)

        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(scheduler.Scheduler, "step", stepped))
            stack.enter_context(patched(scheduler.Scheduler, "submit", submitted))
            stack.enter_context(patched(T, "decode_step_slots", timed))
            rec = serve.run(ctx, capture=False)
    return {"workload": workload, "seed": seed, "window_s": rec["window_s"],
            "median_ms": {k: statistics.median(v) for k, v in sorted(times.items())},
            "mean_ms": {k: statistics.fmean(v) for k, v in sorted(times.items())},
            "n": {k: len(v) for k, v in sorted(times.items())},
            "ms": {k: [round(x, 3) for x in v] for k, v in sorted(times.items())}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", type=int, choices=[0, 1], default=0)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    build = ROOT / "build"          # every cache the program builds stays in the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    line = (cost(args.workload, args.seed, args.seconds, args.device) if args.cost
            else readings(args.workload, args.seed, args.seconds, args.device,
                          trace_out=args.trace_out))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
