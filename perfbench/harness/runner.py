"""One run of one cell: set-up, the window, the check, the result line.

``run(root, workload, seed, seconds, trace, device)`` returns ``(result,
checks)``: the JSON object the benchmark prints last, and the numbers it
compared, each beside its limit.  The cell's kind (its traffic file's
``kind``) names the module that drives it (``harness.train``,
``harness.serve``); its metrics are read from what that module recorded by
the readers ``metrics/<name>.py``.
"""
from __future__ import annotations

import importlib
import math
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@dataclass
class Context:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float

    def peak_bytes(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        torch.cuda.synchronize()
        return max(torch.cuda.max_memory_allocated(i) for i in range(self.cell.chips))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Tuple[Dict, List[Tuple[str, float, float]]]:
    cell = manifest.cell(root, workload)
    device = torch.device(device)
    if device.type == "cuda":
        from repro_torch.device import resolve_device

        device = resolve_device("cuda:0")   # TF32 off, as the port's entry points set it
    ctx = Context(cell, int(seed), float(seconds), bool(trace), device, t_start)
    kind = importlib.import_module(f"harness.{cell.traffic['kind']}")
    rec = kind.run(ctx)
    rec["chips"] = cell.chips

    numbers = rec.pop("numbers")
    checks = [(name, numbers.get(name, math.nan), spec["limit"])
              for name, spec in cell.limits.items()]
    correct = bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    steps = rec.get("steps")
    attempted = len(steps) if steps is not None else rec.get("attempted", 0)
    failed = sum(not s["finite"] for s in steps) if steps is not None else 0
    dev: Dict = {"platform": "gpu" if device.type == "cuda" else device.type,
                 "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                 "count": cell.chips, "memory_peak_bytes": rec.get("peak_bytes")}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks
