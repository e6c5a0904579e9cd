"""§5.2 experiment: multi-class classification with the 1.77M-param MLP.

Counterpart of ``repro.apps.classification``: HO-SGD against the Fig. 2
baselines (sync-SGD, RI-SGD, PA-SGD, ZO-SGD, ZO-SVRG-Ave, QSGD).
``run_comparison`` gains ``engine=`` (the HO-SGD DirectionEngine; the other
methods keep their own), ``device=`` and ``params0=`` (initial parameters,
e.g. a JAX run's, carried across with ``repro_torch.convert``), and records
each step's ``comm_bytes`` where the method books them (the round programs).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import (
    HOSGDConfig, make_ho_sgd, make_pa_sgd, make_qsgd, make_ri_sgd,
    make_sync_sgd, make_zo_sgd, make_zo_svrg_ave,
)
from repro_torch.core.ho_sgd import to_device
from repro_torch.data.libsvm import try_load
from repro_torch.data.synthetic import Dataset, batches, make_classification
from repro_torch.device import resolve_device
from repro_torch.metrics import MeterRegistry
from repro_torch.models.mlp import init_mlp_classifier, mlp_accuracy, mlp_loss
from repro_torch.tree import tree_leaves

def load_dataset(name: str, n_train: int = 8192) -> Dataset:
    real = try_load(name)
    return real if real is not None else make_classification(name, n_train=n_train)


def build_methods(m: int, tau: int, lr: float, zo_lr: float, mu: float,
                  dataset_batch, which: Optional[List[str]] = None,
                  engine: str = "fused") -> Dict:
    all_methods = {
        "ho_sgd": lambda: make_ho_sgd(
            mlp_loss, HOSGDConfig(tau=tau, mu=mu, m=m, lr=lr, zo_lr=zo_lr,
                                  engine=engine)),
        "sync_sgd": lambda: make_sync_sgd(mlp_loss, m, lr=lr),
        "ri_sgd": lambda: make_ri_sgd(mlp_loss, m, tau=tau, lr=lr, mu_r=0.25),
        "pa_sgd": lambda: make_pa_sgd(mlp_loss, m, tau=tau, lr=lr),
        "zo_sgd": lambda: make_zo_sgd(mlp_loss, m, mu=mu, lr=zo_lr),
        "zo_svrg_ave": lambda: make_zo_svrg_ave(
            mlp_loss, m, mu=mu, lr=zo_lr, dataset=dataset_batch),
        "qsgd": lambda: make_qsgd(mlp_loss, m, s=8, lr=lr),
    }
    which = which or list(all_methods)
    return {k: all_methods[k]() for k in which}


def run_comparison(
    dataset_name: str,
    n_iters: int = 200,
    m: int = 4,
    B: int = 64,
    tau: int = 8,
    hidden: int = 1300,            # the paper's 1.3K+1.3K hidden, d>1.69M
    lr: float = 0.05,
    mu: float = 1e-3,
    methods: Optional[List[str]] = None,
    seed: int = 0,
    eval_every: int = 20,
    engine: str = "fused",
    device="cuda",
    params0=None,
) -> Dict[str, Dict]:
    """Train each method from the same initial parameters on the same
    batches.  Per method: ``loss``, ``order``, ``comm_bytes`` (None where
    the method books none), ``acc``, ``iter_s`` (host time of each step up
    to its loss being on the host, so device work is included), ``wall_s``,
    ``meter``, ``final_acc``, ``final_loss`` and the final ``params``.  Every
    step gets ``key=seed``, as in the reference."""
    dev = resolve_device(device)
    ds = load_dataset(dataset_name)
    if params0 is None:
        params0 = init_mlp_classifier(torch.Generator().manual_seed(seed),
                                      ds.n_features, ds.n_classes,
                                      hidden=hidden, device=dev)
    else:
        params0 = params_from_numpy(params0, device=dev)
    d = sum(int(x.numel()) for x in tree_leaves(params0))
    zo_lr = lr * 30.0 / d          # the paper's 30/d step-size scaling
    anchor = {"x": ds.x_train[:1024], "y": ds.y_train[:1024]}
    meths = build_methods(m, tau, lr, zo_lr, mu, anchor, methods, engine=engine)

    results = {}
    test = to_device({"x": ds.x_test, "y": ds.y_test}, dev)
    for name, meth in meths.items():
        params, state = params0, meth.init(params0)
        meter = MeterRegistry(d)
        hist = {"loss": [], "order": [], "comm_bytes": [], "acc": [], "iter_s": []}
        data = batches(ds, m * B, seed=seed + 1)
        t0 = time.perf_counter()
        for t in range(n_iters):
            batch = next(data)
            ts = time.perf_counter()
            params, state, metrics = meth.step(t, params, state, batch, seed)
            hist["loss"].append(float(metrics["loss"]))
            hist["iter_s"].append(time.perf_counter() - ts)
            hist["order"].append(int(metrics["order"]))
            hist["comm_bytes"].append(metrics.get("comm_bytes"))
            meter.tick(meth)
            if (t + 1) % eval_every == 0 or t == n_iters - 1:
                hist["acc"].append((t + 1, float(mlp_accuracy(params, test))))
        hist["wall_s"] = time.perf_counter() - t0
        hist["meter"] = meter.summary()
        hist["final_acc"] = hist["acc"][-1][1]
        hist["final_loss"] = float(np.mean(hist["loss"][-10:]))
        hist["params"] = params
        results[name] = hist
    return results
