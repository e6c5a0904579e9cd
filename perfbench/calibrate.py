"""The readings a cell's limits are set from, on the chip, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,... \\
        [--controls 3] [--seconds 20] [--out readings.jsonl] [--capture-cost 1]

For every seed, one run of the cell (its set-up, a window of ``--seconds``
at the cell's own load, its check) gives the program's reading of each
number the check compares.  On the first ``--controls`` seeds it also reads
the control, the plain reference computed with fp8 products put in the
program's place, and the faults a run of that kind can have: for a
training cell, the reference with half of every batch left out (the mean
taken over the rest) in the program's place; for a serving cell, one
served token altered where it is produced.  (A state left unchanged reads 1
by the training numbers' measure and needs no run.)  One JSON line a seed.

With ``--capture-cost 1`` (a serving cell) each seed's window is served
twice instead, with and without the harness's capture of the served
logits, and the line gives both rates: what the capture costs the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def readings(workload: str, seed: int, seconds: float, control: bool, device: str = "cuda",
             root: Path = ROOT) -> dict:
    import torch

    from harness import manifest, runner

    cell = manifest.cell(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.device import resolve_device

        dev = resolve_device("cuda:0")
    kind = cell.traffic["kind"]
    mod = __import__(f"harness.{kind}", fromlist=["run"])
    t0 = time.perf_counter()
    ctx = runner.Context(cell, seed, seconds, False, dev, t0)
    rec = mod.run(ctx)
    line = {"seed": seed, "program": rec["numbers"], "setup_s": rec["setup_s"],
            "window_s": rec["window_s"], "run_s": time.perf_counter() - t0,
            "peak_gb": None if rec.get("peak_bytes") is None else rec["peak_bytes"] / 1e9}
    if kind == "train":
        line["steps_s"] = [round(s["s"], 3) for s in rec["steps"]]
        prog, ref = rec["_prog"], rec["_ref"]
        line["losses"], line["ref_losses"] = prog["losses"], ref["losses"]
        line["leaves"] = ["/".join(p) for p in ref["paths"]]
        line["grad_norms"], line["ref_grad_norms"] = prog["grad_norms"], ref["grad_norms"]
        line["changes"], line["ref_changes"] = prog["changes"], ref["changes"]
        line["evaluated"] = {t: [f for f, _ in ev] for t, ev in prog["evals"].items()}
        line["ref_perturbed"] = ref["perturbed"]
        med = float(np.median(ref["grad_norms"]))
        keep = [g >= 1e-3 * med for g in ref["grad_norms"]]
        line["change3_gap"] = mod._leaf_gap(prog["changes"][-1], ref["changes"][-1], keep)
        if control:
            model, mix = cell.config["model"], cell.traffic
            ref = rec["_ref"]
            ctrl = mod.reference(model, mix, seed, dev, control=True)
            line["control"] = mod.numbers(ctrl, ref, mix)
            half = mod.reference(model, mix, seed, dev, rows=slice(0, mix["sequences"] // 2))
            line["half_batch"] = mod.numbers(half, ref, mix)
    else:
        seqs, logits = rec["_sample"], rec["_ref_logits"]
        line["checked_tokens"] = rec["checked_tokens"]
        line["finished_sampled"] = len(seqs)
        if control and seqs:
            model = cell.config["model"]
            ctrl = mod.reference_logits(model, seed, dev, seqs, control=True)
            chosen = [(p, [int(r.argmax()) for r in c]) for (p, _), c in zip(seqs, ctrl)]
            line["control"] = {"logit_gap": max(mod.gaps(logits, chosen, mod.top(ctrl)))}
            p, o = seqs[0]
            bad = [(p, [(o[0] + 1) % model["vocab_size"]] + o[1:])]
            line["altered_token"] = {"logit_gap": max(mod.gaps(logits[:1], bad,
                                                               rec["_answers"][:1]))}
    return line


def capture_cost(workload: str, seed: int, seconds: float, root: Path = ROOT) -> dict:
    import torch

    from harness import manifest, runner, serve

    cell = manifest.cell(root, workload)
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda:0")
    read = manifest.reader(root, "serve_tokens_per_s")
    line = {"seed": seed}
    for capture in (True, False):
        torch.cuda.empty_cache()
        rec = serve.run(runner.Context(cell, seed, seconds, False, dev, time.perf_counter()),
                        capture=capture)
        line["with" if capture else "without"] = {"serve_tokens_per_s": read(rec),
                                                  "window_s": rec["window_s"],
                                                  "prefills": rec["prefills"],
                                                  "generated": rec["generated"]}
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--capture-cost", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        line = (capture_cost(args.workload, seed, args.seconds) if args.capture_cost
                else readings(args.workload, seed, args.seconds, i < args.controls))
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
