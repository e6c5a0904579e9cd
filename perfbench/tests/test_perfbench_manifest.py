"""The benchmark's manifest and the files it names (CPU)."""
import dataclasses
import json

import pytest

import tinybench  # noqa: F401  (puts the harness and the port on the path)
from harness import manifest, weights

ROOT = tinybench.REPO
BENCH = manifest.load(ROOT)


def test_manifest_keeps_the_rules():
    assert manifest.check_manifest(BENCH) == []
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("field,bad", [
    ("name", "has space"), ("name", "a/b"), ("name", "x" * 65), ("name", "µs"),
    ("unit", "tokens per s"), ("unit", "µs"), ("better", "more"), ("source", "program_span"),
])
def test_manifest_refuses_a_bad_entry(field, bad):
    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"][0][field] = bad
    assert manifest.check_manifest(bench)


def test_duplicate_and_dangling_names_are_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(bench["workloads"][0]))
    bench["per_layer"][0]["moves"] = "no_such_metric"
    faults = manifest.check_manifest(bench)
    assert any("duplicate" in f for f in faults) and any("moves" in f for f in faults)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = manifest.cell(ROOT, workload)
    assert cell.traffic["kind"] in ("train", "serve")
    assert cell.limits and all(spec["lower"] < spec["limit"] < spec["upper"]
                               for spec in cell.limits.values())
    for m in cell.end_to_end + cell.per_layer:
        assert callable(manifest.reader(ROOT, m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_is_the_ports_at_full_size(name):
    """The port's configuration whole; each key ``reduced`` names is a
    departure from the source's architecture that the file states, none a
    width, a depth or a count of heads."""
    from repro_torch.configs import get_config

    (entry,) = [c for c in BENCH["configs"] if c["name"] == name]
    data = json.loads((ROOT / entry["file"]).read_text())
    assert entry["reduced"] == data["reduced"] == sorted(data["departures"])
    assert not set(data["reduced"]) & set(data["model"])
    port = dataclasses.asdict(get_config(name))
    served = {"use_pallas"} if data["model"]["use_pallas"] else set()
    assert {k: v for k, v in data["model"].items() if k not in served} == \
        {k: v for k, v in port.items() if k not in served}


def test_weights_take_the_ports_layout():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import tree_flatten

    for model in (tinybench.TINY_HYBRID, tinybench.TINY_SSM):
        mine, mine_def = tree_flatten(weights.make(model, 7, "cpu"))
        port, port_def = tree_flatten(init_model(3, ModelConfig(**model), device="cpu"))
        assert mine_def == port_def
        assert [(x.shape, x.dtype) for x in mine] == [(x.shape, x.dtype) for x in port]
        again, _ = tree_flatten(weights.make(model, 7, "cpu"))
        assert all((a == b).all() for a, b in zip(mine, again))
    full = json.loads((ROOT / "perfbench/configs/hymba-1.5b.json").read_text())["model"]
    assert weights.n_params(full) == 1_662_264_000
