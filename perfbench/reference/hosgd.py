"""Plain reference of HO-SGD's first steps (Algorithm 1 of arXiv:2003.12423), one worker.

A first-order step at ``t % tau == 0`` takes the gradient of the batch's
mean loss and commits ``p - lr g``.  A zeroth-order step draws the
pre-shared-seed direction ``v`` (``hashdir``), normalises it by the norm of
the whole tree, evaluates the loss at ``p`` and at ``p + mu v / |v|``, and
commits ``p - zo_lr (d / mu) (f1 - f0) v / |v|`` with the m = 1 worker's
coefficient.  Every sum, product and loss is float32 (the norm's sum in
float64); only the committed parameters are rounded to the dtype each leaf
is stored in, which the configuration states.  The direction is made in
blocks, so that no leaf's counters are held at once.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference import hashdir as H
from reference.decoder import F32, Decoder, flatten, unflatten

BLOCK = 1 << 25


def _direction_leaf(n: int, salt: int, device):
    for start, count in H.blocks(n, BLOCK):
        yield start, count, H.gaussians(start, count, salt, device)


def sumsq(sizes: List[int], seed: int, t: int, worker: int, device) -> float:
    total = 0.0
    for i, n in enumerate(sizes):
        salt = H.fold(seed, t, worker, i)
        for _, _, g in _direction_leaf(n, salt, device):
            total += float(torch.sum(g * g, dtype=torch.float64))
    return total


def add_direction(leaves: List[torch.Tensor], scale: float, seed: int, t: int,
                  worker: int, out_dtypes=None) -> List[torch.Tensor]:
    """``leaf + scale * v`` for every leaf, computed in float32 and stored in
    ``out_dtypes[i]`` (float32 when None)."""
    out = []
    for i, x in enumerate(leaves):
        salt = H.fold(seed, t, worker, i)
        dt = F32 if out_dtypes is None else out_dtypes[i]
        flat = x.reshape(-1)
        res = torch.empty(flat.shape, dtype=dt, device=x.device)
        for start, count, g in _direction_leaf(flat.numel(), salt, x.device):
            res[start:start + count] = (flat[start:start + count].to(F32) + scale * g).to(dt)
        out.append(res.reshape(x.shape))
    return out


def follow(cfg: Dict, weights: Dict, batches: List[Dict], method: Dict, seed: int,
           device, control: bool = False, rows: slice = slice(None)) -> Dict:
    """The first ``len(batches)`` steps from ``weights`` (the stored dtypes);
    ``rows`` keeps only those rows of every batch (a fault: part of the batch
    left out).  Returns each step's loss, the first FO step's gradient norm
    per leaf, each leaf's change from the start after every step, each ZO
    step's loss at the perturbed point, its ``1 / |v|`` and its direction on
    the leaves ``direction_leaves`` names, and ``d``, ``mu`` and ``zo_lr``."""
    model = Decoder(cfg, control=control)
    items = flatten(weights)
    paths = [p for p, _ in items]
    store = [x for _, x in items]
    dtypes = [x.dtype for x in store]
    sizes = [x.numel() for x in store]
    d = sum(sizes)
    tau, lr, mu = method["tau"], method["lr"], method["mu"]
    zo_lr = lr * method["zo_lr_scale"] / d
    out = {"losses": [], "grad_norms": None, "directions": {}, "changes": [], "inv_norms": {},
           "perturbed": {}, "zo_lr": zo_lr, "d": d, "mu": mu}
    start = list(store)

    def loss_at(leaves, batch):
        toks = torch.as_tensor(batch["tokens"][rows], device=device).to(torch.int64)
        labs = torch.as_tensor(batch["labels"][rows], device=device).to(torch.int64)
        tree = unflatten(list(zip(paths, leaves)))
        return model.loss(tree, toks, labs)

    for t, batch in enumerate(batches):
        if t % tau == 0:
            leaves = [x.to(F32, copy=True).requires_grad_(True) for x in store]
            with torch.enable_grad():
                loss = loss_at(leaves, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
            if out["grad_norms"] is None:
                out["grad_norms"] = [float(torch.linalg.vector_norm(g)) for g in grads]
            with torch.no_grad():
                store = [(x.detach() - lr * g).to(dt) for x, g, dt in zip(leaves, grads, dtypes)]
            del leaves, grads
        else:
            with torch.no_grad():
                inv = 1.0 / math.sqrt(sumsq(sizes, seed, t, 0, device) + 1e-30)
                out["inv_norms"][t] = inv
                loss = loss_at([x.to(F32) for x in store], batch)
                f1 = loss_at(add_direction(store, mu * inv, seed, t, 0), batch)
                out["perturbed"][t] = float(f1)
                coeff = (d / mu) * (float(f1) - float(loss))
                step = -zo_lr * coeff * inv
                for i, (path, x) in enumerate(zip(paths, store)):
                    if path in method.get("direction_leaves", ()):
                        v = H.gaussians(0, x.numel(), H.fold(seed, t, 0, i), device)
                        out["directions"][(t, path)] = v.reshape(x.shape)
                store = add_direction(store, step, seed, t, 0, dtypes)
        out["losses"].append(float(loss.detach()))
        out["changes"].append([float(torch.linalg.vector_norm(x.to(F32) - x0.to(F32)))
                               for x, x0 in zip(store, start)])
    out["paths"] = paths
    return out
