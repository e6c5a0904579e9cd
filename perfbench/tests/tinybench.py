"""A copy of the benchmark at a size a CPU test can run: tiny configurations,
mixes and limits written as new files beside the real ones, and entries for
them in a copy of ``BENCHMARK.json``, in a temporary directory."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "perfbench"
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_HYBRID = dict(json.loads((BENCH / "configs" / "hymba-1.5b.json").read_text())["model"],
                   name="hymba-tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=128, window=8, dtype="float32",
                   grad_accum=2)
TINY_SSM = dict(json.loads((BENCH / "configs" / "falcon-mamba-7b.json").read_text())["model"],
                name="mamba-tiny", n_layers=2, d_model=64, dt_rank=8, vocab_size=128,
                dtype="float32", use_pallas=False)
TRAIN_MIX = dict(json.loads((BENCH / "traffic" / "ho-tau8.json").read_text()),
                 sequences=4, seq_len=16, tau=4, mu=0.05)
SERVE_MIX = dict(json.loads((BENCH / "traffic" / "docs1k-backlog.json").read_text()),
                 requests=24, strata=4, prompt_len={"dist": "loguniform", "lo": 8, "hi": 32},
                 output_len={"dist": "uniform", "lo": 2, "hi": 6}, aligned_every=8, align=8,
                 slots=4, max_seq=40, warmup_prompt_lens=[32, 31], check_requests=4)
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "fo_change_gap": 1e-3, "zo_perturb_gap": 1e-3,
                "zo_update_gap": 1e-3}
SERVE_LIMITS = {"logit_gap": 1e-3}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make(root: Path) -> Path:
    """A checkout-like directory under ``root`` with the tiny cells
    ``hymba-tiny.train`` and ``mamba-tiny.serve`` added beside the real ones."""
    root = Path(root)
    shutil.copytree(BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = root / "perfbench"
    for cfg in (TINY_HYBRID, TINY_SSM):
        _write(base / "configs" / f"{cfg['name']}.json",
               {"name": cfg["name"], "source": "a test", "reference": "reference/decoder.py",
                "reduced": [], "model": cfg})
        bench["configs"].append({"name": cfg["name"], "source": "a test",
                                 "file": f"perfbench/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "a test"})
    _write(base / "traffic" / "tiny-train.json", TRAIN_MIX)
    _write(base / "traffic" / "tiny-serve.json", SERVE_MIX)
    cells = {"hymba-tiny.train": ("hymba-tiny", "tiny-train", TRAIN_LIMITS),
             "mamba-tiny.serve": ("mamba-tiny", "tiny-serve", SERVE_LIMITS)}
    for name, (cfg, mix, limits) in cells.items():
        bench["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                   "why": "a test"})
        _write(base / "limits" / f"{name}.json", {k: {"limit": v} for k, v in limits.items()})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            if any(w.startswith(("hymba-1.5b", "hymba")) for w in m["workloads"]) and \
                    m["name"].endswith(("train", "train_tokens_per_s")):
                m["workloads"].append("hymba-tiny.train")
            if m["name"].endswith(("serve", "serve_tokens_per_s")):
                m["workloads"].append("mamba-tiny.serve")
    _write(root / "BENCHMARK.json", bench)
    return root


def run(root: Path, workload: str, seed: int = 2**31 + 11, seconds: float = 0.0,
        trace: bool = False, device: str = "cpu"):
    from harness import runner

    return runner.run(Path(root), workload, seed, seconds, trace, device, time.perf_counter())
