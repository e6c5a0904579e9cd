"""The port's apps against the JAX package's, plus the package rules.

* Fig. 2: ``run_comparison`` at small width (ho_sgd / sync_sgd / zo_sgd)
  from the JAX initial parameters, losses within rtol 1e-4;
* Fig. 1: the victim, the attack loss and a short HO-SGD attack run;
* import hygiene: importing every module of ``repro_torch`` pulls in neither
  ``jax`` nor ``repro``;
* device default: entry points refuse to run on a GPU-less machine unless
  the caller asks for ``device="cpu"``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import attack as JA
from repro.apps.classification import run_comparison as jrun_comparison
from repro.core import HOSGDConfig as JCfg, make_ho_sgd as jmake, run_method as jrun
from repro.data.synthetic import make_digits
from repro.models.mlp import init_mlp_classifier as jinit
from repro_torch.apps import attack as TA
from repro_torch.apps.classification import build_methods, run_comparison
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core import HOSGDConfig, make_ho_sgd, run_method

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_fig2_run_comparison_matches_jax():
    kw = dict(n_iters=8, m=4, B=16, tau=4, hidden=64, eval_every=4,
              methods=["ho_sgd", "sync_sgd", "zo_sgd"])
    jres = jrun_comparison("covtype", **kw)
    p0 = jinit(jax.random.key(0), 54, 7, hidden=64)     # what the JAX app used
    tres = run_comparison("covtype", engine="flat", device="cpu",
                          params0={k: np.asarray(v) for k, v in p0.items()}, **kw)
    assert list(tres) == list(jres)
    for name in jres:
        np.testing.assert_allclose(tres[name]["loss"], jres[name]["loss"], rtol=1e-4,
                                   err_msg=name)
        assert [t for t, _ in tres[name]["acc"]] == [t for t, _ in jres[name]["acc"]]
        np.testing.assert_allclose([a for _, a in tres[name]["acc"]],
                                   [a for _, a in jres[name]["acc"]], atol=2e-3)
        assert tres[name]["meter"]["scalars_sent_per_worker"] == \
            jres[name]["meter"]["scalars_sent_per_worker"]
    assert tres["ho_sgd"]["order"] == [1, 0, 0, 0, 1, 0, 0, 0]


@pytest.mark.parametrize("name", ["ri_sgd", "pa_sgd", "qsgd", "zo_svrg_ave"])
def test_unported_baselines_raise(name):
    """The four baselines that raised "not ported" before their port now
    build and take a step (the name is kept from then): finite loss, the
    parameters' structure kept."""
    rng = np.random.default_rng(0)
    anchor = {"x": rng.normal(size=(32, 54)).astype(np.float32),
              "y": rng.integers(0, 7, 32).astype(np.int32)}
    meth = build_methods(4, 8, 0.05, 1e-6, 1e-3, anchor, [name])[name]
    from repro_torch.models.mlp import init_mlp_classifier

    params = init_mlp_classifier(torch.Generator().manual_seed(0), 54, 7, hidden=8,
                                 device="cpu")
    state = meth.init(params)
    new, _, metrics = meth.step(0, params, state, anchor, 0)
    assert np.isfinite(float(metrics["loss"]))
    assert sorted(new) == sorted(params)
    assert all(new[k].shape == params[k].shape for k in params)


@pytest.fixture(scope="module")
def victims():
    """The JAX victim and its port twin, trained from the same start."""
    key = jax.random.key(0)
    jv, jacc = JA.train_victim(key, steps=30)
    start = jinit(key, 900, 10, hidden=128)                # train_victim's init
    tv, tacc = TA.train_victim(None, steps=30, device="cpu",
                               params0={k: np.asarray(v) for k, v in start.items()})
    return jv, jacc, tv, tacc


def test_fig1_victim_matches_jax(victims):
    jv, jacc, tv, tacc = victims
    assert tacc == pytest.approx(jacc, abs=2e-3)
    got = tree_to_numpy(tv)
    for k in sorted(got):
        np.testing.assert_allclose(got[k], np.asarray(jv[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_fig1_attack_loss_and_run_match_jax(victims):
    jv, _, _, _ = victims
    tv = params_from_numpy({k: np.asarray(v) for k, v in jv.items()}, device="cpu")
    jloss, jz = JA.make_attack_loss(jv, c=5.0)
    tloss, tz = TA.make_attack_loss(tv, c=5.0)
    x, y = make_digits(n=64, seed=1)
    rng = np.random.default_rng(0)
    pert = (0.1 * rng.normal(size=900)).astype(np.float32)
    jb = {"a": jnp.asarray(x[:25]), "y": jnp.asarray(y[:25])}
    tb = {"a": torch.from_numpy(x[:25]), "y": torch.from_numpy(y[:25])}
    assert float(tloss({"x": torch.from_numpy(pert)}, tb)) == pytest.approx(
        float(jloss({"x": jnp.asarray(pert)}, jb)), rel=1e-5)
    tm = TA.attack_metrics(tv, tz, {"x": torch.from_numpy(pert)}, x[:10], y[:10])
    jm = JA.attack_metrics(jv, jz, {"x": jnp.asarray(pert)}, x[:10], y[:10])
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)

    def data():
        r = np.random.default_rng(1)
        while True:
            idx = r.integers(0, 64, size=25)
            yield {"a": x[idx], "y": y[idx]}

    d, n = 900, 6
    cfg = dict(tau=4, mu=1.0 / np.sqrt(d * n), m=5, lr=30.0 / d)
    jh = jrun(jmake(jloss, JCfg(**cfg)), {"x": jnp.zeros((d,))}, data(), n)
    th = run_method(make_ho_sgd(tloss, HOSGDConfig(**cfg, engine="flat")),
                    {"x": torch.zeros(d)}, data(), n)
    assert th["order"] == jh["order"]
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)


def test_importing_the_port_pulls_in_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # every module was imported


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """No GPU and no explicit device="cpu": every entry point raises."""
    from repro_torch.device import resolve_device
    from repro_torch.models.mlp import init_mlp_classifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: resolve_device(),
                 lambda: init_mlp_classifier(0, 4, 2, hidden=3),
                 lambda: params_from_numpy({"x": np.zeros(3, np.float32)}),
                 lambda: run_comparison("covtype", n_iters=1),
                 lambda: TA.train_victim(0, steps=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
