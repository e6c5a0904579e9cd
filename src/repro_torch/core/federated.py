"""Federated partial participation for the round IR, in PyTorch.

Counterpart of ``repro.core.federated`` (README §RoundProgram): who
participates in a round, on top of ``repro_torch.core.rounds``.

  * ``ClientSampling(n_clients, cohort_k, seed, availability)`` is a frozen
    spec attached to a ``RoundProgram``.  Every round draws a seeded cohort
    of K of N client ids without replacement, then applies per-client
    availability churn (a seeded Bernoulli dropout mask over the drawn
    cohort, at least one survivor).  The draws are numpy's, copied from the
    reference, so the same spec and ``t`` give the reference's cohort, bit
    for bit.
  * Each sampled client computes its round ``local`` on its own data shard:
    ``cohort_shards`` draws client c's rows from the global batch with an rng
    keyed on the client's identity (and ``t``), never its position in the
    cohort.
  * ``fed_avg_program`` builds FedAvg (``dropout=0``) and FedDropoutAvg as
    round programs that commit through the ``masked_average`` collective.

HO-SGD goes federated by passing ``client_sampling=`` to
``rounds.ho_sgd_program``: the cohort's FO gradients all-reduce, the cohort's
ZO coefficients all-gather, and the direction streams survive sampling
because they are keyed on the client id (any int: the salts are folded on
the host).

What differs from the reference: FedDropoutAvg's masks come from
``jax.random.bernoulli`` there, which the port does not reproduce (threefry).
Here ``dropout_masks`` draws them on each leaf's device from a
``torch.Generator`` there, one per leaf, seeded with ``fold(seed, t, client,
leaf)``, so a client's mask is invariant to the rest of the cohort (the CPU's
and the card's generators give different draws); a test hands the port the
reference's masks by replacing ``dropout_masks``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import directions as D
from repro_torch.core import rounds as R
from repro_torch.core.ho_sgd import value_and_grad
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

#: namespace salt so federated draws never collide with other np seed uses
_FED_SALT = 0x0FED


@dataclass(frozen=True)
class ClientSampling:
    """K-of-N partial participation: the seeded cohort schedule.

    ``cohort_for(t)`` draws the round-``t`` cohort: ``cohort_k`` of
    ``n_clients`` ids without replacement, then an independent per-client
    availability draw (probability ``availability`` of showing up; at least
    one survivor -- an all-down round re-admits a seeded pick).  Ids come
    back sorted ascending.

    ``client_sizes()`` is the per-client dataset-size vector (seeded
    lognormal counts >= 1, fixed per spec) -- the masked-average weights.
    """

    n_clients: int
    cohort_k: int
    seed: int = 0
    availability: float = 1.0

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        if not 1 <= self.cohort_k <= self.n_clients:
            raise ValueError(f"cohort_k={self.cohort_k} not in [1, n_clients="
                             f"{self.n_clients}]")
        if not 0.0 < self.availability <= 1.0:
            raise ValueError(f"availability must be in (0, 1], got {self.availability}")

    def _rng(self, *salt: int) -> np.random.Generator:
        return np.random.default_rng([_FED_SALT, self.seed, *salt])

    def cohort_for(self, t: int) -> Tuple[int, ...]:
        """Sorted client ids participating in round ``t`` (live cohort)."""
        rng = self._rng(1, int(t))
        ids = rng.choice(self.n_clients, size=self.cohort_k, replace=False)
        if self.availability < 1.0:
            up = rng.random(self.cohort_k) < self.availability
            if not up.any():
                up[int(rng.integers(self.cohort_k))] = True
            ids = ids[up]
        return tuple(int(i) for i in np.sort(ids))

    def client_sizes(self) -> np.ndarray:
        """(n_clients,) int64 dataset sizes -- seeded once per spec."""
        rng = self._rng(2)
        raw = rng.lognormal(mean=4.0, sigma=0.75, size=self.n_clients)
        return np.maximum(1, np.round(raw)).astype(np.int64)

    def client_weights(self, cohort: Sequence[int]) -> np.ndarray:
        """Masked-average weights of a cohort: each client's dataset size."""
        sizes = self.client_sizes()
        return sizes[np.asarray(list(cohort), dtype=np.int64)].astype(np.float64)


def cohort_shards(batch: Any, cohort: Sequence[int], t: int,
                  cs: ClientSampling) -> Any:
    """Stack each sampled client's own shard of the global batch on a new
    leading cohort axis.  Client c's rows are drawn by an rng keyed on
    (spec seed, c, t), so its data stream is invariant to who else was
    sampled; every client gets ``n_rows // cohort_k`` rows, the same
    per-worker batch the always-on replay shards.  Tensor leaves are
    indexed on their own device."""
    n = int(tree_leaves(batch)[0].shape[0])
    per = n // cs.cohort_k
    if per < 1:
        raise ValueError(f"batch of {n} rows cannot feed cohorts of {cs.cohort_k}")
    rows = np.stack([
        np.random.default_rng([_FED_SALT, cs.seed, 3, int(c), int(t)])
        .choice(n, size=per, replace=False)
        for c in cohort])

    def take(x):
        if isinstance(x, torch.Tensor):
            return x[torch.from_numpy(rows).to(x.device)]
        return x[rows]

    return tree_map(take, batch)


# --------------------------------------------------------------------------- #
# FedAvg / FedDropoutAvg as round programs
# --------------------------------------------------------------------------- #
def dropout_masks(seed: int, t: int, worker: int, leaves: List[torch.Tensor],
                  keep: float) -> List[torch.Tensor]:
    """FedDropoutAvg's keep masks for one client's uploaded leaves: leaf i's
    mask is ``uniform < keep`` drawn on the leaf's device from a generator
    there seeded with ``fold(seed, t, worker, i)``."""
    out = []
    for i, x in enumerate(leaves):
        gen = torch.Generator(device=x.device).manual_seed(D.fold(seed, t, worker, i))
        out.append(torch.rand(tuple(x.shape), generator=gen, device=x.device) < keep)
    return out


def fed_avg_round(loss_fn: Callable, *, lr: float, local_steps: int,
                  dropout: float = 0.0, seed: int = 0,
                  wire: Optional[R.Wire] = None, tag: str = "fed_avg",
                  ) -> R.Round:
    """One communication round of FedAvg / FedDropoutAvg.

    ``local``: each client runs ``local_steps`` SGD steps (autograd, float32
    arithmetic, cast back to each leaf's dtype) over equal micro-slices of
    its shard and uploads the resulting model tree.  With ``dropout > 0``
    the client zeroes a seeded fraction of every uploaded leaf
    (``dropout_masks``, keyed on (t, client id)).

    ``apply``: the ``masked_average`` collective hands over ``(avg, wsum)``;
    coordinates no surviving client sent (``wsum == 0``) keep the server's
    old value.
    """
    wire = wire or R.Wire()
    drop = float(dropout)
    if not 0.0 <= drop < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {drop}")

    def local(t, worker, model, shard):
        n = int(tree_leaves(shard)[0].shape[0])
        if n % local_steps:
            raise ValueError(f"client shard of {n} rows cannot split into "
                             f"{local_steps} steps")
        size = n // local_steps
        p, losses = model, []
        for k in range(local_steps):
            mb = tree_map(lambda x: x[k * size:(k + 1) * size], shard)
            loss, g = value_and_grad(loss_fn, p, mb)
            p = tree_map(lambda a, b: (a.to(torch.float32)
                                       - lr * b.to(torch.float32)).to(a.dtype), p, g)
            losses.append(loss)
        if drop > 0.0:
            leaves, treedef = tree_flatten(p)
            masks = dropout_masks(seed, int(t), int(worker), leaves, 1.0 - drop)
            p = tree_unflatten(treedef, [torch.where(k, x, torch.zeros_like(x))
                                         for k, x in zip(masks, leaves)])
        return p, torch.mean(torch.stack(losses))

    def apply(t, params, state, reduced, workers, aux):
        avg, wsum = reduced
        params = tree_map(lambda p, a, s: torch.where(s > 0, a.to(p.dtype), p),
                          params, avg, wsum)
        return params, state, {"loss": torch.mean(aux)}

    return R.Round(tag, 1, "masked_average", local, apply, wire=wire,
                   meta={"loss_fn": loss_fn, "lr": lr,
                         "local_steps": local_steps, "dropout": drop})


def fed_avg_program(loss_fn: Callable, sampling: ClientSampling, *,
                    lr: float, local_steps: int = 4, dropout: float = 0.0,
                    seed: int = 0, wire: Optional[R.Wire] = None,
                    name: str = "fed_avg") -> R.RoundProgram:
    """FedAvg (``dropout=0``) / FedDropoutAvg as a ``RoundProgram``: every
    round is the same ``masked_average`` round over a freshly sampled cohort;
    ``m = cohort_k`` (the program's worker slots are the cohort).  Table-1
    hooks: each round uploads |cohort| model trees and costs ``local_steps``
    gradient evaluations per client."""
    rnd = fed_avg_round(loss_fn, lr=lr, local_steps=local_steps,
                        dropout=dropout, seed=seed, wire=wire, tag=name)

    def init(params):
        return {}

    def round_for(t: int, state) -> R.RoundStep:
        return R.RoundStep(rnd, t, {})

    return R.RoundProgram(
        name, sampling.cohort_k, init, round_for,
        comm_scalars=lambda d: float(sampling.cohort_k) * d,
        fevals=lambda d: 0.0,
        gevals=lambda d: float(local_steps),
        client_sampling=sampling,
    )
