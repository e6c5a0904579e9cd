"""Pluggable hardware cost models: compute time from FLOP counts, link time
from an alpha–beta model.

Counterpart of ``repro.sim.costs``: a copy (host arithmetic only), but for
``tree_fwd_flops``, which counts a tree's values with ``repro_torch.tree``.

The compute side prices the two oracle kinds the paper distinguishes — a
first-order gradient (forward + backward) and a zeroth-order function
evaluation — from per-problem FLOP counts, so an iteration's time is
``(fevals + ratio * gevals) * fwd_flops / flops_per_sec``.  The counts per
iteration come from the replayed ``Method``'s analytic cost model
(``Method.fevals`` / ``Method.gevals``, resolved per step order by the
runner), never re-invented here.

The communication side is the classic alpha–beta model: a collective moving
``nbytes`` (per worker, the ``CommLedger`` receive convention) costs
``alpha + nbytes / bandwidth``.  Byte counts are NOT computed in this module
— the runner reads them from the ``CommLedger`` of the replayed step
programs, or from ``repro_torch.dist.compress`` wire estimates (see
``repro_torch.sim.runner``), so the simulator can never drift from what the real
steps book.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class LinkModel:
    """alpha–beta link: ``time(n) = alpha + n * beta`` (beta = 1/bandwidth)."""

    alpha: float          # per-collective latency, seconds
    beta: float           # seconds per byte

    def time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.alpha + float(nbytes) * self.beta


#: recognized all-reduce algorithms (``CollectiveModel.kind``)
COLLECTIVE_KINDS = ("flat", "ring", "tree", "gossip")


def ring_all_reduce_time(link: LinkModel, nbytes: float, w: int) -> float:
    """Ring all-reduce over ``w`` workers: reduce-scatter + all-gather,
    ``2(w-1)`` rounds each moving ``nbytes / w``:
    ``2(w-1)·alpha + 2(w-1)/w · nbytes·beta``."""
    if nbytes <= 0 or w <= 1:
        return 0.0
    return 2.0 * (w - 1) * link.alpha + (2.0 * (w - 1) / w) * float(nbytes) * link.beta


def tree_all_reduce_time(link: LinkModel, nbytes: float, w: int) -> float:
    """Binary-tree all-reduce: ``ceil(log2(w))`` reduce rounds up the tree
    plus the same number of broadcast rounds down, each moving the full
    buffer: ``2·log2(w) · (alpha + nbytes·beta)``."""
    if nbytes <= 0 or w <= 1:
        return 0.0
    rounds = 2.0 * math.ceil(math.log2(w))
    return rounds * (link.alpha + float(nbytes) * link.beta)


def flat_all_reduce_time(link: LinkModel, nbytes: float, w: int) -> float:
    """The flat model: one fully-switched exchange, latency and wire time
    independent of ``w`` (every worker receives ``nbytes`` at once)."""
    if w <= 1:
        return 0.0
    return link.time(nbytes)


def gossip_exchange_time(link: LinkModel, nbytes: float, w: int) -> float:
    """One ring-gossip round (the ``neighbor_exchange`` collective of the
    round IR): every worker receives its ring neighbors' payloads —
    ``min(2, w-1)`` sequential transfers of ``nbytes`` each:
    ``k·(alpha + nbytes·beta)``, independent of the ring length beyond the
    two-neighbor degree (the decentralized scaling win)."""
    if nbytes <= 0 or w <= 1:
        return 0.0
    k = min(2, w - 1)
    return k * (link.alpha + float(nbytes) * link.beta)


_ALGOS = {"flat": flat_all_reduce_time, "ring": ring_all_reduce_time,
          "tree": tree_all_reduce_time, "gossip": gossip_exchange_time}


@dataclass(frozen=True)
class CollectiveModel:
    """Prices one all-reduce of ``nbytes`` (per worker, the ``CommLedger``
    receive convention) over ``w`` participating workers.

    ``kind`` selects the single-link algorithm (``flat`` — the switched
    exchange; ``ring``; ``tree``).  With ``pods > 1`` the reduce is
    hierarchical: the ``kind`` algorithm runs intra-pod over
    ``ceil(w / pods)`` workers on ``link``, then a ring exchange runs
    inter-pod over ``pods`` on ``inter_link`` (the Topology's slow link).
    ``w`` is the CURRENT membership — elastic clusters shrink/grow it and
    the round structure reprices accordingly, while byte counts stay
    whatever the replayed programs booked.
    """

    link: LinkModel
    kind: str = "flat"
    pods: int = 1
    inter_link: Optional[LinkModel] = None

    def __post_init__(self):
        assert self.kind in COLLECTIVE_KINDS, \
            f"unknown collective {self.kind!r}; have {COLLECTIVE_KINDS}"
        assert self.pods >= 1
        if self.pods > 1:
            assert self.inter_link is not None, \
                "multi-pod collectives need an inter-pod LinkModel"

    def all_reduce_time(self, nbytes: float, w: int) -> float:
        intra, inter = self.time_components(nbytes, w)
        return intra + inter

    def time_components(self, nbytes: float, w: int) -> "tuple[float, float]":
        """``(intra_pod_s, inter_pod_s)`` split of the collective's time —
        the contention model routes each component through its own shared
        link (the pod link vs the Topology's inter-pod link).  Single-pod
        collectives put everything in the intra component."""
        if nbytes <= 0 or w <= 1:
            return 0.0, 0.0
        algo = _ALGOS[self.kind]
        if self.pods <= 1:
            return algo(self.link, nbytes, w), 0.0
        wpp = max(1, math.ceil(w / self.pods))
        intra = algo(self.link, nbytes, wpp)
        inter = ring_all_reduce_time(self.inter_link, nbytes,
                                     min(self.pods, w))
        return intra, inter


def exposed_comm_time(cm: CollectiveModel, nbytes: float, w: int,
                      buckets: int, compute_s: float) -> float:
    """Exposed (critical-path) communication time of one overlapped round.

    With the payload split into ``buckets`` buckets, bucket k's collective
    pipelines behind the compute producing chunk k+1, so only
    ``max(0, comm − overlappable)`` of the collective's time lands on the
    critical path, where ``overlappable = compute · (B−1)/B`` — the first
    chunk must finish before the first bucket can depart, so 1/B of the
    round's compute can never hide traffic.  This is the optimistic
    pipelining bound: bucket latencies are assumed hidden inside the
    pipeline, and ``comm`` is the full payload's collective time (bytes are
    unchanged by bucketing — the ``CommLedger`` invariant).

    ``buckets=1`` degenerates exactly to the strict compute-then-communicate
    price (``comm`` fully exposed), keeping every unbucketed pin intact.
    """
    comm = cm.all_reduce_time(nbytes, w)
    if buckets <= 1 or comm <= 0.0:
        return comm
    overlappable = float(compute_s) * (buckets - 1) / buckets
    return max(0.0, comm - overlappable)


def overlapped_step_time(cm: CollectiveModel, nbytes: float, w: int,
                         buckets: int, compute_s: float) -> float:
    """Critical-path time of one overlapped round: local compute plus the
    exposed tail of its bucketed collective."""
    return float(compute_s) + exposed_comm_time(cm, nbytes, w, buckets,
                                                compute_s)


@dataclass(frozen=True)
class ComputeModel:
    """Prices oracle calls on one worker's batch shard.

    ``fwd_flops`` is the FLOP count of ONE loss evaluation on one worker's
    shard; a gradient evaluation (forward + backward) costs
    ``fwd_bwd_ratio`` times that (3.0 is the standard dense-matmul
    estimate: backward ≈ 2× forward).
    """

    fwd_flops: float
    flops_per_sec: float
    fwd_bwd_ratio: float = 3.0

    def flops(self, fevals: float, gevals: float) -> float:
        return (fevals + self.fwd_bwd_ratio * gevals) * self.fwd_flops

    def time(self, fevals: float, gevals: float, speed: float = 1.0) -> float:
        return self.flops(fevals, gevals) / (self.flops_per_sec * speed)


@dataclass(frozen=True)
class StepCost:
    """One iteration's priced quantities (per worker)."""

    fevals: float         # zeroth-order oracle calls
    gevals: float         # first-order oracle calls
    comm_bytes: int       # wire bytes per worker (0 = no collective)


def tree_fwd_flops(params_like: Any, per_worker_batch: int) -> float:
    """Dense estimate for an arbitrary parameter tree: 2 FLOPs per parameter
    per sample (one multiply-add per weight — exact for the MLP/quadratic
    problems the sim tests replay)."""
    from repro_torch.tree import tree_leaves

    d = sum(int(x.numel()) for x in tree_leaves(params_like))
    return 2.0 * d * per_worker_batch


def config_fwd_flops(cfg: Any, per_worker_batch: int, seq: int) -> float:
    """Transformer estimate from a ``ModelConfig``: 2 * active params per
    token (the standard decoder FLOP model; attention's quadratic term is
    below the matmul term at the seq lengths the sim rehearses)."""
    return 2.0 * cfg.param_count(active_only=True) * per_worker_batch * seq


def per_order_step_costs(fevals: float, gevals: float, comm_bytes: int) -> StepCost:
    """Convenience constructor kept for symmetry with the runner factories."""
    return StepCost(float(fevals), float(gevals), int(comm_bytes))


def validate_against_method(method, d: int, costs_by_order, order_mix) -> None:
    """Cross-check: per-order eval counts, amortized over the order mix,
    must reproduce the Method's analytic per-iteration counters.

    ``order_mix`` maps order -> fraction of iterations; used by tests so a
    runner-constructed cost table can never drift from ``Method.fevals`` /
    ``Method.gevals``.
    """
    fe = sum(order_mix[o] * costs_by_order[o].fevals for o in order_mix)
    ge = sum(order_mix[o] * costs_by_order[o].gevals for o in order_mix)
    assert math.isclose(fe, method.fevals(d), rel_tol=1e-9, abs_tol=1e-12), \
        f"fevals drift: per-order {fe} vs analytic {method.fevals(d)}"
    assert math.isclose(ge, method.gevals(d), rel_tol=1e-9, abs_tol=1e-12), \
        f"gevals drift: per-order {ge} vs analytic {method.gevals(d)}"
