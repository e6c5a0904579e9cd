"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a metric's reader ``metrics/<name>.py`` (a function
``read(run)`` that returns a number or None) and a cell's limits
``limits/<workload>.json``, all under the benchmark's folder.  Adding a cell
adds files and entries; no file that is there changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@dataclass
class Cell:
    name: str
    config: Dict           # the configuration file
    traffic: Dict          # the traffic file
    limits: Dict           # name -> {"limit": ...}
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def check_manifest(bench: Dict) -> List[str]:
    """The name, unit and shape rules a manifest keeps; the faults found."""
    bad = []
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for w in bench["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in bench["configs"]:
        names += c["reduced"]
    bad += [f"name {n!r}" for n in names if not NAME.match(n)]
    metrics = bench["end_to_end"] + bench["per_layer"]
    bad += [f"unit {m['unit']!r}" for m in metrics if not UNIT.match(m["unit"])]
    bad += [f"better {m['better']!r}" for m in metrics if m["better"] not in ("lower", "higher")]
    bad += [f"source {m['name']}" for m in bench["end_to_end"] if m["source"] not in SOURCES_E2E]
    bad += [f"source {m['name']}" for m in bench["per_layer"] if m["source"] not in SOURCES]
    for group in (bench["configs"], bench["workloads"], metrics):
        seen = [x["name"] for x in group]
        bad += [f"duplicate {n}" for n in set(seen) if seen.count(n) > 1]
    e2e = {m["name"] for m in bench["end_to_end"]}
    bad += [f"moves {m['name']}" for m in bench["per_layer"] if m["moves"] not in e2e]
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    cfgs = {c["name"] for c in bench["configs"]}
    bad += [f"config of {w['name']}" for w in bench["workloads"] if w["config"] not in cfgs]
    for text in [w["why"] for w in bench["workloads"]] + [c["source"] for c in bench["configs"]]:
        if not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
            bad.append(f"text {text[:40]!r}")
    return bad


def load(root: Path) -> Dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def folder(root: Path, bench: Dict) -> Path:
    return Path(root) / bench["paths"][0]


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(root: Path, workload: str) -> Cell:
    bench = load(root)
    base = folder(root, bench)
    (w,) = [w for w in bench["workloads"] if w["name"] == workload] or [None]
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    limits = base / "limits" / f"{workload}.json"
    return Cell(
        name=workload,
        config=json.loads((Path(root) / c["file"]).read_text()),
        traffic=json.loads((base / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(limits.read_text()) if limits.exists() else {},
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


def reader(root: Path, name: str) -> Callable[[Dict], Optional[float]]:
    path = folder(root, load(root)) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
