"""The port's LLM trainer (``launch/train``) and loss against the reference.

* The loss: ``loss_fn`` of the gemma2-2b smoke model (float32, vocab 512)
  equal to the reference's within rtol 1e-5 on the same parameters and
  tokens, dense (``ce_chunk`` 0) and streaming (``ce_chunk`` 96: six
  chunks, the last slice clamped to start at 416 and overlapping the one
  before); gradients within rtol 1e-4 of ``jax.grad`` (atol 1e-4 of the
  leaf's largest gradient).  Remat on and off give bitwise-equal losses and
  gradients in the port; each stacked layer leaf reaches autograd through
  one ``unbind``.
* The CLI: ``main`` of both packages at gemma2-2b smoke size (9 steps,
  tau 3, batch 4, seq 32) for ``--engine flat`` and ``pallas``, with
  ``--compress qsgd`` and with ``--tau-schedule``.  The port runs on the CPU
  (``--device cpu``) from the reference's initial parameters, handed over by
  monkeypatching ``repro_torch.launch.train.init_model``; QSGD is handed the
  reference's uniforms by monkeypatching ``repro_torch.dist.compress.uniform``
  (as tests/test_torch_baselines.py does).  Per-step CSV losses agree within
  rtol 1e-4 (the engine tests' step-level rule), ``comm_bytes`` and the
  FO/ZO order exactly; the reference's ``restore`` reads the port's
  ``--ckpt`` bit for bit; the trace has one span per CSV step carrying its
  bytes.  On this jax, ``jax.make_mesh`` gives Explicit axes, under which the
  reference's embedding gather raises (tests/test_distributed.py's
  ``test_train_driver_end_to_end`` fails so); the reference runs here on
  Auto axes, by monkeypatching ``repro.launch.train.make_test_mesh``.
* ``python -m repro_torch.launch.train --device cpu`` in a fresh process
  imports no ``jax`` or ``repro`` module and books the reference's bytes.
* MoE and hybrid architectures at smoke size (``qwen3-moe-235b-a22b``,
  ``arctic-480b``, ``hymba-1.5b``) through both CLIs, engine flat: order,
  bytes and CSV losses as above (the MoE aux term is in both losses).
* What the port refuses: ``--xla-overlap``, a frontend architecture (with
  the reference's own message), and ``--device cuda`` without a GPU.
* ``init_params`` on a mesh that cuts nothing gives the shapes' tree as
  meta tensors.
* An SSM model (falcon-mamba-7b smoke): its loss and gradients against
  ``jax.value_and_grad``, the never-read ``norm2`` leaves' gradients zero in
  both, and the CLI's FO step runs.
"""
import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro.launch.train as JTR
from repro.checkpoint import restore as jrestore
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.checkpoint import restore
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import directions as D
from repro_torch.core.ho_sgd import value_and_grad
from repro_torch.dist import compress as C
from repro_torch.launch import train as TTR
from repro_torch.models import transformer as T
from repro_torch.obs import load_trace_events, spans_from_events
from repro_torch.tree import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMOKE = ["--arch", "gemma2-2b", "--reduce", "smoke", "--steps", "9", "--tau", "3",
         "--batch", "4", "--seq", "32"]


def _configs(**kw):
    return (jget_config("gemma2-2b").reduced().with_(**kw),
            get_config("gemma2-2b").reduced().with_(**kw))


def _ref_params(jcfg):
    return JT.init_model(jax.random.key(0), jcfg)


def _batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, size=(2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3] = -1                      # a masked position inside the row
    return toks, labels


@pytest.mark.parametrize("ce_chunk", [0, 96])
def test_loss_and_grad_match_reference(ce_chunk):
    jcfg, cfg = _configs(ce_chunk=ce_chunk)
    assert T.ce_chunk_size(cfg) == ce_chunk
    jp = _ref_params(jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks, labels = _batch()
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jl, jg = jax.value_and_grad(lambda q: JT.loss_fn(jcfg, q, jb))(jp)
    tl, tg = value_and_grad(lambda q, b: T.loss_fn(cfg, q, b), p, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4 * np.abs(a).max())


@pytest.mark.parametrize("ce_chunk", [0, 96])
def test_remat_gives_bitwise_equal_gradients(ce_chunk):
    _, cfg = _configs(ce_chunk=ce_chunk)
    p = T.init_model(0, cfg, device="cpu")
    toks, labels = _batch()
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    on = value_and_grad(lambda q, b: T.loss_fn(cfg.with_(remat=True), q, b), p, tb)
    off = value_and_grad(lambda q, b: T.loss_fn(cfg.with_(remat=False), q, b), p, tb)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(on[1]), tree_leaves(off[1])))


def test_stacked_layers_reach_autograd_through_one_unbind():
    """Each stacked layer leaf feeds the graph through one ``unbind`` (its
    backward stacks the L gradients once), not one select per layer (each
    zero-filling a gradient of the whole leaf and adding it: L leaf-sized
    fills and adds a backward pass)."""
    _, cfg = _configs()
    cfg = cfg.with_(n_layers=4)
    p = T.init_model(0, cfg, device="cpu")
    stacked = [x.requires_grad_(True) for x in tree_leaves(p["layers"])]
    toks, labels = _batch()
    loss = T.loss_fn(cfg, p, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)})
    users = {id(x): [] for x in stacked}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and id(getattr(nxt, "variable", None)) in users:
                users[id(nxt.variable)].append(node.name())
            todo.append(nxt)
    assert list(users.values()) == [["UnbindBackward0"]] * len(stacked)


def test_streaming_ce_clamps_and_masks_the_last_chunk():
    """V = 512, chunk 96: six chunks, the last starting at 416 (not 480) and
    its first 64 columns masked; equal to the dense CE within rtol 1e-6."""
    _, cfg = _configs(ce_chunk=96)
    g = torch.Generator().manual_seed(1)
    head = torch.randn(32, 512, generator=g)
    h = torch.randn(2, 16, 32, generator=g)
    labels = torch.randint(0, 512, (2, 16), generator=g)
    labels[:, -1] = -1
    labels[0, 0] = 500                    # in the overlap of the last two chunks
    labels[1, 0] = 420
    dense = T.cross_entropy(T.softcap(h @ head, cfg.final_softcap), labels)
    torch.testing.assert_close(T.cross_entropy_streaming(cfg, head, h, labels), dense,
                               rtol=1e-6, atol=0.0)


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #
def _auto_mesh(data=4, model=2, pod=0):
    return jax.make_mesh((data, model), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _run_both(tmp_path, monkeypatch, extra, arch="gemma2-2b"):
    """The reference's and the port's ``main`` on the same flags; returns
    both CSVs and the reference's initial parameters."""
    jcfg = JTR.size_override(jget_config(arch), "smoke")
    jp = _ref_params(jcfg)
    monkeypatch.setattr(JTR, "make_test_mesh", _auto_mesh)
    monkeypatch.setattr(TTR, "init_model", lambda gen, cfg, device: params_from_numpy(
        jax.tree.map(np.asarray, jp), device=device))
    if "qsgd" in extra:
        # the legacy codec at m = 1: leaf i of FO step t keyed fold(fold(0, t), i)
        keys = {D.fold(D.fold(0, t), i): jax.random.fold_in(
                    jax.random.fold_in(jax.random.key(0), t), i)
                for t in range(9) for i in range(len(jax.tree.leaves(jp)))}
        monkeypatch.setattr(C, "uniform", lambda key, shape, device: torch.from_numpy(
            np.array(jax.random.uniform(keys[key], tuple(shape)))))
    out = {}
    for name, main, dev in (("ref", JTR.main, []), ("port", TTR.main, ["--device", "cpu"])):
        d = tmp_path / name
        main(SMOKE + extra + dev + ["--arch", arch, "--log", str(d / "log.csv"),
                                    "--ckpt", str(d / "ck"), "--trace", str(d / "trace.json")])
        out[name] = _csv(d / "log.csv")
    return out["ref"], out["port"], jp


CLI_CASES = {
    "flat": ["--engine", "flat"],
    "pallas": ["--engine", "pallas"],
    "flat_qsgd": ["--engine", "flat", "--compress", "qsgd"],
    "flat_tau_schedule": ["--engine", "flat", "--tau-schedule", "linear:2,4,9"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_reference(tmp_path, monkeypatch, case):
    ref, port, jp = _run_both(tmp_path, monkeypatch, CLI_CASES[case])
    assert len(port) == len(ref) == 9
    assert [r["order"] for r in port] == [r["order"] for r in ref]
    assert [int(r["comm_bytes"]) for r in port] == [int(r["comm_bytes"]) for r in ref]
    assert "0" in [r["order"] for r in port] and "1" in [r["order"] for r in port]
    np.testing.assert_allclose([float(r["loss"]) for r in port],
                               [float(r["loss"]) for r in ref], rtol=1e-4)
    # the reference's restore reads the port's checkpoint, bit for bit
    ck = str(tmp_path / "port" / "ck")
    got, step = jrestore(ck, jp)
    mine, step2 = restore(ck, jp)
    assert step == step2 == 9
    for a, b in zip(jax.tree.leaves(got), tree_leaves(mine)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # one span per step, named and booked as the CSV; the program's own
    # spans (dotted names) nest inside them, one fo.step or zo.step a step
    spans = spans_from_events(load_trace_events(str(tmp_path / "port" / "trace.json")))
    steps = [s for s in spans if s.kind == "compute" and "." not in s.name]
    assert [s.name for s in steps] == [f"{'fo' if r['order'] == '1' else 'zo'}/{r['step']}"
                                       for r in port]
    assert [s.nbytes for s in steps] == [int(r["comm_bytes"]) for r in port]
    assert [s.name for s in spans if s.kind == "checkpoint"] == ["ckpt_save"]
    program = [s for s in spans if "." in s.name]
    assert [s.name for s in program if s.name.endswith(".step")] == [
        f"{'fo' if r['order'] == '1' else 'zo'}.step" for r in port]
    assert all(any(st.t0 <= s.t0 and s.t1 <= st.t1 for st in steps) for s in program)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b", "hymba-1.5b"])
def test_cli_moe_and_hybrid_match_reference(tmp_path, monkeypatch, arch):
    ref, port, _ = _run_both(tmp_path, monkeypatch, ["--engine", "flat"], arch=arch)
    assert len(port) == len(ref) == 9
    assert [r["order"] for r in port] == [r["order"] for r in ref] == ["1", "0", "0"] * 3
    assert [int(r["comm_bytes"]) for r in port] == [int(r["comm_bytes"]) for r in ref]
    d = get_config(arch).reduced().param_count()
    assert int(port[0]["comm_bytes"]) >= 4 * d and int(port[1]["comm_bytes"]) == 4
    np.testing.assert_allclose([float(r["loss"]) for r in port],
                               [float(r["loss"]) for r in ref], rtol=1e-4)


def test_cli_module_imports_no_jax(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` in a fresh process:
    no jax or repro module loaded, 4·d bytes on FO steps and 4 on ZO steps in
    the order F Z Z, and a checkpoint the port restores."""
    code = ("import runpy, sys; sys.argv = ['train'] + sys.argv[1:]; "
            "runpy.run_module('repro_torch.launch.train', run_name='__main__'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print('LEAKED', bad)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code, *SMOKE, "--engine", "flat",
                        "--device", "cpu", "--log", str(tmp_path / "l.csv"),
                        "--ckpt", str(tmp_path / "ck")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LEAKED []" in r.stdout and "done; final loss" in r.stdout
    rows = _csv(tmp_path / "l.csv")
    d = get_config("gemma2-2b").reduced().param_count()
    assert [r["order"] for r in rows] == ["1", "0", "0"] * 3
    assert [int(r["comm_bytes"]) for r in rows] == [4 * d, 4, 4] * 3
    assert f"comm/fo_bytes_per_step,measured={4 * d},analytic={4 * d}" in r.stdout
    like = T.init_model(0, get_config("gemma2-2b").reduced(), device="cpu")
    _, step = restore(str(tmp_path / "ck"), like)
    assert step == 9


@pytest.mark.parametrize("argv,match", [
    (["--xla-overlap"], "no counterpart"),
    (["--arch", "pixtral-12b"], "use examples/ drivers for frontend archs"),
    (["--arch", "hubert-xlarge"], "use examples/ drivers for frontend archs"),
])
def test_cli_refuses_what_is_not_ported(argv, match):
    with pytest.raises(SystemExit, match=match):
        TTR.main(SMOKE[4:] + ["--device", "cpu"] + argv)


def test_cli_device_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is used, not refused")
    with pytest.raises(RuntimeError, match="cuda"):
        TTR.main(SMOKE)


def test_ssm_gradient_matches_reference_and_unread_leaves_get_zero(tmp_path):
    """falcon-mamba has no feed-forward sublayer, so its layers' ``norm2``
    is never read: ``value_and_grad`` gives it a zero gradient, as
    ``jax.grad`` does, and the trainer's FO step runs (it raised before)."""
    jcfg = jget_config("falcon-mamba-7b").reduced()
    cfg = get_config("falcon-mamba-7b").reduced()
    jp = _ref_params(jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks, labels = _batch()
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jl, jg = jax.value_and_grad(lambda q: JT.loss_fn(jcfg, q, jb))(jp)
    tl, tg = value_and_grad(lambda q, b: T.loss_fn(cfg, q, b), p, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4 * np.abs(a).max())
    assert not tg["layers"]["norm2"]["scale"].any()
    assert not np.asarray(jg["layers"]["norm2"]["scale"]).any()
    loss = TTR.main(["--device", "cpu", "--arch", "falcon-mamba-7b", "--reduce", "smoke",
                    "--steps", "3", "--tau", "3", "--batch", "4", "--seq", "32",
                    "--log", str(tmp_path / "l.csv")])
    assert np.isfinite(loss)


def test_init_params_keeps_no_second_tree_on_an_unsharded_mesh():
    """The shapes' tree the trainer keeps for the whole run holds no data:
    meta tensors on a mesh that cuts nothing (the initial parameters
    themselves before, a dead copy on the card, 5.3 GB at gemma2-2b)."""
    from torch_dist_helpers import FakeMesh

    cfg = get_config("gemma2-2b").reduced()
    mesh = FakeMesh(dict(data=0, model=0), data=2, model=1)
    params, like = TTR.init_params(cfg, mesh, 0, torch.device("cpu"))
    assert all(x.device.type == "meta" for x in tree_leaves(like))
    assert [(tuple(x.shape), x.dtype) for x in tree_leaves(like)] == \
        [(tuple(x.shape), x.dtype) for x in tree_leaves(params)]
    assert all(x.device.type == "cpu" for x in tree_leaves(params))
