"""Zeroth-order stochastic gradient estimation (Algorithm 1, eq. (4)), in PyTorch.

Counterpart of ``repro.core.zo_grad``:
``G_mu(x, zeta, v) = (d/mu) * [F(x + mu*v, zeta) - F(x, zeta)] * v``
with exactly two function evaluations per worker per iteration; only the
scalar coefficient is communicated, the vector is regenerated from the seed.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core import directions as D
from repro_torch.core.engine import make_engine
from repro_torch.tree import tree_leaves, tree_map


@torch.no_grad()
def zo_coefficient(loss_fn: Callable, params: Any, batch: Any, v_tree: Any,
                   mu: float, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (c, f0): the scalar ZO coefficient and the base loss value."""
    f0 = loss_fn(params, batch)
    f1 = loss_fn(D.tree_axpy(torch.tensor(mu, dtype=torch.float32), v_tree,
                             params), batch)
    c = (dim / mu) * (f1 - f0)
    return c.to(torch.float32), f0


@torch.no_grad()
def zo_gradient(loss_fn: Callable, params: Any, batch: Any, seed: int, t,
                worker: int, mu: float, engine: str = "tree"
                ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Full single-worker ZO gradient estimate (c * v), plus (c, f0)."""
    eng = make_engine(engine, params, seed)
    c, f0 = eng.zo_coeff(loss_fn, params, batch, t, int(worker), mu)
    g = eng.reconstruct(c.reshape(1), t, workers=[int(worker)])
    return g, c, f0


@torch.no_grad()
def reconstruct_update(params: Any, coeffs: torch.Tensor, seed: int, t,
                       engine: str = "tree", vmap_workers: bool = False) -> Any:
    """(1/m) * sum_i c_i * v_{t,i} regenerated locally from the scalars;
    ``vmap_workers`` contracts the m directions of each leaf at once."""
    eng = make_engine(engine, params, seed)
    rec = eng.reconstruct(coeffs, t, vmap_workers=vmap_workers)
    return tree_map(lambda a: a / coeffs.shape[0], rec)


@torch.no_grad()
def smoothed_loss(loss_fn: Callable, params: Any, batch: Any, mu: float,
                  generator: torch.Generator, n_samples: int = 64
                  ) -> torch.Tensor:
    """Monte-Carlo estimate of f_mu(x) = E_u[f(x + mu*u)] (Definition 1),
    u uniform in the unit ball; the draws come from ``generator`` (CPU)."""
    dim = D.tree_dim(params)
    vals = []
    for _ in range(n_samples):
        u = tree_map(lambda p: torch.randn(tuple(p.shape), generator=generator)
                     .to(p.device), params)
        ssq = sum(torch.sum(torch.square(x)) for x in tree_leaves(u))
        u = tree_map(lambda x: x * torch.rsqrt(ssq.to(x.device)), u)
        # uniform in the ball: scale by r^(1/d) with r ~ U(0,1)
        r = torch.rand((), generator=generator) ** (1.0 / dim)
        vals.append(loss_fn(D.tree_axpy(mu * r, u, params), batch))
    return torch.mean(torch.stack(vals))
