"""The port's simulated-cluster CLI (``repro_torch.launch.sim``) against the
reference's, on the CPU.

``main`` of both packages on the same flags (the MLP at hidden 12 on the
acoustic stand-in, m = 4, global batch 32, tau 4, 12 iterations), the port on
``--device cpu`` from the reference's initial parameters, handed over by
monkeypatching ``repro_torch.launch.sim.init_mlp_classifier`` (as
tests/test_torch_train.py hands the trainer its model), QSGD's uniforms
handed over as in ``torch_sim_helpers``.  Cases: HO-SGD
and sync-SGD; ``--federated 64:4`` with fed-HO-SGD and FedAvg;
``--compress qsgd``; ``--pods 2`` with a ring; ``--trace``.  The CSV's
``method``, ``iter``, ``order``, ``t_sim`` and ``comm_bytes`` are equal
exactly and ``loss`` to rtol 1e-4; the JSON's ``results`` are equal but each
``final_loss`` (rtol 1e-4), and its ``cluster`` is the reference's plus the
port's ``device``; the printed lines are equal but their ``final_loss``; the
trace files are equal byte for byte.  On this jax the reference's
one-device ZO step needs ``repro.compat.HAS_PARTIAL_AUTO_COLLECTIVES`` off
(``torch_sim_helpers``).

``python -m repro_torch.launch.sim --device cpu`` in a fresh process imports
no ``jax`` or ``repro`` module; ``--device cuda`` without a GPU raises.
"""
import csv
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.launch.sim as JSIM
import torch_sim_helpers as H
from repro.data.synthetic import make_classification
from repro.models.mlp import init_mlp_classifier as jinit_mlp
from repro_torch.convert import params_from_numpy
from repro_torch.launch import sim as TSIM

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
COMMON = ["--hidden", "12", "--iters", "12", "--batch", "32", "--tau", "4",
          "--eval-every", "4", "--target-loss", "0.01", "--bandwidth", "1e6"]
CASES = {
    "ho_sync": ["--methods", "ho_sgd", "sync_sgd"],
    "federated": ["--federated", "64:4", "--availability", "0.75",
                  "--methods", "fed_ho_sgd", "fed_avg", "--local-steps", "2"],
    "qsgd": ["--methods", "ho_sgd", "--compress", "qsgd"],
    "pods": ["--methods", "ho_sgd", "--pods", "2", "--collective", "ring",
             "--inter-bandwidth", "2.5e5", "--max-staleness", "1"],
    "trace": ["--methods", "ho_sgd", "pa_gossip", "--straggler-prob", "0.3"],
}


@pytest.fixture(autouse=True)
def reference_auto_branch(monkeypatch):
    H.reference_auto_branch(monkeypatch)


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _run_both(tmp_path, monkeypatch, capsys, extra):
    ds = make_classification("acoustic", seed=0)
    jp = jax.tree.map(np.asarray, jinit_mlp(jax.random.key(0), ds.n_features, ds.n_classes,
                                            hidden=12))
    monkeypatch.setattr(TSIM, "init_mlp_classifier",
                        lambda gen, n_features, n_classes, hidden, device:
                        params_from_numpy(jp, device=device))
    H.hand_over_draws(monkeypatch, len(jp), "per_worker")
    out = {}
    for name, main, dev in (("ref", JSIM.main, []), ("port", TSIM.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        summaries = main(COMMON + extra + dev + [
            "--log", str(d / "log.csv"), "--json", str(d / "out.json"),
            "--trace", str(d / "trace.json")])
        lines = [ln.replace(str(d), "<dir>") for ln in capsys.readouterr().out.splitlines()]
        traces = {p.name: p.read_bytes() for p in sorted(d.glob("trace*.json"))}
        with open(d / "out.json") as f:
            js = json.load(f)
        out[name] = (summaries, lines, _csv(d / "log.csv"), js, traces)
    return out["ref"], out["port"]


def _split_loss(lines):
    """The printed lines with their ``final_loss`` values taken out."""
    pat = re.compile(r"final_loss=(\S+)")
    losses = [float(m.group(1)) for ln in lines for m in [pat.search(ln)] if m]
    return [pat.sub("final_loss=*", ln) for ln in lines], losses


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_reference(tmp_path, monkeypatch, capsys, case):
    (jsum, jlines, jrows, jjs, jtr), (tsum, tlines, trows, tjs, ttr) = _run_both(
        tmp_path, monkeypatch, capsys, CASES[case])
    keys = ("method", "iter", "order", "t_sim", "comm_bytes")
    assert [[r[k] for k in keys] for r in trows] == [[r[k] for k in keys] for r in jrows]
    assert len(trows) == 12 * len(tsum)
    np.testing.assert_allclose([float(r["loss"]) for r in trows],
                               [float(r["loss"]) for r in jrows], rtol=1e-4)
    assert {r["order"] for r in trows} >= {"1"}
    for name in jsum:
        got, want = dict(tsum[name]), dict(jsum[name])
        assert got.pop("final_loss") == pytest.approx(want.pop("final_loss"), rel=1e-4)
        assert got == want
        assert got["t_to_target"] == float("inf")
    assert tjs["results"].keys() == jjs["results"].keys()
    for name in jjs["results"]:
        got, want = dict(tjs["results"][name]), dict(jjs["results"][name])
        assert got.pop("final_loss") == pytest.approx(want.pop("final_loss"), rel=1e-4)
        assert got == want
    device = tjs["cluster"].pop("device")
    assert device == "cpu" and tjs["cluster"] == {**jjs["cluster"], "log": tjs["cluster"]["log"],
                                                  "json": tjs["cluster"]["json"],
                                                  "trace": tjs["cluster"]["trace"]}
    (tl, tloss), (jl, jloss) = _split_loss(tlines), _split_loss(jlines)
    assert tl == jl
    np.testing.assert_allclose(tloss, jloss, rtol=2e-3)    # printed at 4 digits
    assert ttr == jtr and len(ttr) == len(tsum)
    if case == "federated":
        assert any(int(r["comm_bytes"]) < 16 for r in trows if r["order"] == "0")
    if case == "pods":
        assert "pods=2" in tl[0] and "staleness=1" in tl[0]


def test_cli_module_imports_no_jax(tmp_path):
    """``python -m repro_torch.launch.sim --device cpu`` in a fresh process:
    no jax or repro module loaded, and the reference's bytes in the CSV (4*d
    on FO rounds, 4*m on ZO rounds)."""
    code = ("import runpy, sys; sys.argv = ['sim'] + sys.argv[1:]; "
            "runpy.run_module('repro_torch.launch.sim', run_name='__main__'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print('LEAKED', bad)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code, *COMMON, "--methods", "ho_sgd",
                        "--device", "cpu", "--iters", "5", "--log", str(tmp_path / "l.csv")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LEAKED []" in r.stdout and "sim/ho_sgd:" in r.stdout
    d = 50 * 12 + 12 + 12 * 12 + 12 + 12 * 3 + 3
    rows = _csv(tmp_path / "l.csv")
    assert [int(r["comm_bytes"]) for r in rows] == [4 * d, 16, 16, 16, 4 * d]


def test_cli_device_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is used, not refused")
    with pytest.raises(RuntimeError, match="cuda"):
        TSIM.main(COMMON + ["--iters", "1"])
