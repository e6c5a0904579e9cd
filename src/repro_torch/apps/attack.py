"""§5.1 experiment: universal adversarial example generation (Appendix A).

Counterpart of ``repro.apps.attack``.  The attack optimizes one universal
perturbation x (d = 900) over K natural images with the Carlini–Wagner-style
loss

  F(x, zeta_k) = c * max{0, f_y(z_k) - max_{j!=y} f_j(z_k)} + ||z_k - a_k||^2,
  z_k = 0.5 * tanh(atanh(2 a_k) + x),

treating the trained classifier as a black box for the ZO methods.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import make_digits
from repro_torch.device import resolve_device
from repro_torch.models.mlp import init_mlp_classifier, mlp_accuracy, mlp_logits, mlp_loss
from repro_torch.opt.optimizers import adam, apply_deltas, const_schedule
from repro_torch.tree import tree_flatten, tree_unflatten


def train_victim(gen, side: int = 30, n_classes: int = 10, hidden: int = 128,
                 steps: int = 300, n_train: int = 4096, device="cuda",
                 params0=None) -> Tuple[Dict, float]:
    """Train the small digit classifier the attack targets (Adam, 1e-3).

    ``gen`` seeds the initial parameters unless ``params0`` (e.g. the JAX
    package's initial parameters as numpy) is given."""
    dev = resolve_device(device)
    x, y = make_digits(n=n_train, side=side, n_classes=n_classes, seed=1)
    if params0 is None:
        params = init_mlp_classifier(gen, side * side, n_classes, hidden=hidden,
                                     device=dev)
    else:
        params = params_from_numpy(params0, device=dev)
    opt = adam(const_schedule(1e-3))
    state = opt.init(params)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    rng = np.random.default_rng(0)
    for t in range(steps):
        idx = torch.from_numpy(rng.integers(0, n_train, 256)).to(dev)
        leaves, treedef = tree_flatten(params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = mlp_loss(tree_unflatten(treedef, req), {"x": xt[idx], "y": yt[idx]})
        grads = torch.autograd.grad(loss, req)
        with torch.no_grad():
            deltas, state = opt.update(tree_unflatten(treedef, list(grads)),
                                       state, params, t)
            params = apply_deltas(params, deltas)
    with torch.no_grad():
        acc = float(mlp_accuracy(params, {"x": xt, "y": yt}))
    return params, acc


def make_attack_loss(victim: Dict, c: float = 1.0):
    """Returns loss_fn(params={'x': perturbation}, batch={'a','y'}) and z_of."""

    def z_of(x, a):
        return 0.5 * torch.tanh(torch.atanh(torch.clamp(2 * a, -0.999, 0.999)) + x)

    def loss_fn(params, batch):
        x = params["x"]
        a, y = batch["a"], batch["y"].long()
        z = z_of(x, a)
        logits = mlp_logits(victim, z)
        gold = torch.gather(logits, -1, y[:, None])[:, 0]
        onehot = torch.nn.functional.one_hot(y, logits.shape[-1]).bool()
        others = torch.where(onehot, torch.full_like(logits, -torch.inf),
                             logits).amax(-1)
        margin = torch.clamp(gold - others, min=0.0)
        dist = torch.sum((z - a) ** 2, -1)
        return torch.mean(c * margin + dist)

    return loss_fn, z_of


@torch.no_grad()
def attack_metrics(victim: Dict, z_of, params, images, labels) -> Dict[str, float]:
    dev = params["x"].device
    images = torch.as_tensor(images).to(dev)
    labels = torch.as_tensor(labels).to(dev).long()
    z = z_of(params["x"], images)
    preds = torch.argmax(mlp_logits(victim, z), -1)
    success = preds != labels
    l2 = torch.sqrt(torch.sum((z - images) ** 2, -1))
    return {
        "success_rate": float(torch.mean(success.to(torch.float32))),
        # as in the JAX package: the mean over the masked array is NaN
        # unless every image was attacked successfully
        "l2_distortion": float(torch.mean(torch.where(success, l2, torch.nan))
                               if bool(torch.any(success)) else torch.mean(l2)),
        "l2_all": float(torch.mean(l2)),
    }
