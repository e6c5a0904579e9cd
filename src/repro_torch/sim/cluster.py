"""ClusterSpec: the simulated hardware — worker speeds, links, failures.

Counterpart of ``repro.sim.cluster``, a copy: the same fields, checks and
numpy draws in the same order (the order is the determinism contract).

One frozen dataclass describes everything stochastic or hardware-shaped
about a simulated cluster; the spec's ``seed`` drives every draw (straggler
slowdowns, jitter, failure arrivals), so the determinism contract is simply:
same ``ClusterSpec`` (including seed) + same replayed method ⇒ identical
event trace.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np

from repro_torch.sim.costs import COLLECTIVE_KINDS, CollectiveModel, LinkModel


@dataclass(frozen=True)
class Topology:
    """Multi-pod link topology: ``pods`` × workers-per-pod, mirroring the
    ``("pod", "data")`` mesh axes ``repro_torch.dist.sharding`` owns.

    Workers inside a pod talk over the ``ClusterSpec``'s (fast) link; pods
    talk over this (slow) inter-pod link.  A hierarchical all-reduce is
    priced as the selected intra-pod algorithm over ``m / pods`` workers
    plus an inter-pod ring exchange over ``pods`` (see
    ``costs.CollectiveModel``).
    """

    pods: int = 1
    inter_alpha: float = 1e-3            # inter-pod latency per collective (s)
    inter_bandwidth: float = 1e8         # inter-pod bytes/s per worker

    def __post_init__(self):
        assert self.pods >= 1
        assert self.inter_bandwidth > 0 and self.inter_alpha >= 0

    @property
    def inter_link(self) -> LinkModel:
        return LinkModel(alpha=self.inter_alpha,
                         beta=1.0 / self.inter_bandwidth)

    def workers_per_pod(self, m: int) -> int:
        """Workers in the fullest pod — a CEIL split, priced exactly like
        ``CollectiveModel.time_components``: sampled federated cohorts and
        shrunken elastic memberships are not pod-divisible, and the fullest
        pod bounds the hierarchical reduce's intra-pod stage."""
        return max(1, math.ceil(m / self.pods))


@dataclass(frozen=True)
class ClusterSpec:
    """Hardware + fault model for one simulated cluster.

    Compute: ``flops_per_sec`` is the base per-worker throughput;
    ``rel_speeds`` (len m, default homogeneous) models persistent
    heterogeneity, while stragglers/jitter are per-(iteration, worker)
    draws: with probability ``straggler_prob`` a worker's iteration takes
    ``straggler_slowdown`` times longer, and ``jitter_sigma`` adds
    lognormal multiplicative noise on top.

    Failures: a Poisson process at ``fail_rate`` failures per simulated
    second (cluster-wide).  In the default (bulk-synchronous) mode a
    failure kills the in-flight iteration; the cluster restores the last
    checkpoint written every ``ckpt_every`` iterations (a REAL
    ``repro_torch.checkpoint`` round-trip in the runner) and pays
    ``restart_time`` simulated seconds before resuming.  With
    ``elastic=True`` a failure instead REMOVES the victim from the
    membership (no rollback): the survivors keep iterating with the
    collective priced at the shrunken ``W``, and the victim rejoins after
    a seeded exponential downtime (mean ``downtime`` seconds) through a
    real checkpoint round-trip, growing ``W`` back.

    Execution: ``max_staleness = 0`` is bulk-synchronous (every iteration
    barriers).  ``max_staleness = s > 0`` lets workers run ZO iterations
    WITHOUT the barrier, each at most ``s`` rounds ahead of the slowest
    worker's committed round; FO sync rounds always barrier, matching
    HO-SGD's semantics (the tau-th exchange is the consistency point).

    Federated (``n_clients > 0``): the cluster's ``m`` worker slots hold a
    sampled cohort of ``cohort_k`` (= m) of ``n_clients`` clients, redrawn
    every round from the ``sampling`` spec (seeded by the cluster seed) with
    per-client ``availability`` churn; the runner prices each round's
    collective at the LIVE cohort size and the trajectory genuinely follows
    the sample.  Federated rounds are server-synchronous — ``max_staleness``
    and ``elastic`` must stay off (churn is the availability mask).

    Links: ``collective`` picks the all-reduce algorithm (``flat`` —
    the switched exchange — ``ring`` or ``tree``); a ``topology`` with
    ``pods > 1`` makes the reduce hierarchical (intra-pod ``collective``
    + inter-pod ring on the topology's slow link).  With ``contention``
    (the latency-honest default) the UNBARRIERED exchanges of async rounds
    route through shared per-pod links plus the inter-pod link
    (``events.LinkContention``): concurrent transfers serialize in
    deterministic (time, worker) order instead of being priced
    independently.  Barriered collectives are unaffected — the
    ``CollectiveModel`` already prices the joint algorithm and nothing else
    is in flight at a barrier — so synchronous specs are bit-identical
    with the flag on or off.
    """

    m: int = 4
    flops_per_sec: float = 1e12
    rel_speeds: Tuple[float, ...] = ()
    alpha: float = 1e-4                  # link latency per collective (s)
    bandwidth: float = 1e9               # bytes/s per worker
    collective: str = "flat"             # all-reduce algorithm (costs.py)
    topology: Optional[Topology] = None  # multi-pod links (None = one pod)
    max_staleness: int = 0               # 0 = bulk-synchronous ZO rounds
    straggler_prob: float = 0.0
    straggler_slowdown: float = 4.0
    jitter_sigma: float = 0.0
    fail_rate: float = 0.0               # failures per simulated second
    elastic: bool = False                # failures shrink W instead of rollback
    downtime: float = 60.0               # mean elastic rejoin delay (s)
    restart_time: float = 30.0           # checkpoint-restore charge (s)
    ckpt_every: int = 0                  # iterations between sim checkpoints
    contention: bool = True              # shared links for async exchanges
    n_clients: int = 0                   # >0: federated client population N
    cohort_k: int = 0                    # sampled clients per round (= m)
    availability: float = 1.0            # per-round client up-probability
    seed: int = 0

    def __post_init__(self):
        assert self.m >= 1
        assert self.bandwidth > 0 and self.flops_per_sec > 0
        assert self.collective in COLLECTIVE_KINDS, \
            f"unknown collective {self.collective!r}; have {COLLECTIVE_KINDS}"
        assert self.max_staleness >= 0
        assert self.downtime > 0
        if self.rel_speeds:
            assert len(self.rel_speeds) == self.m, \
                f"{len(self.rel_speeds)} rel_speeds for m={self.m}"
            assert all(s > 0 for s in self.rel_speeds)
        if self.elastic:
            assert self.m >= 2, "elastic membership needs m >= 2"
        if self.fail_rate > 0 and not self.elastic:
            assert self.ckpt_every > 0, \
                "failure injection needs ckpt_every > 0 (restore source)"
        assert 0.0 < self.availability <= 1.0, \
            f"availability must be in (0, 1], got {self.availability}"
        if self.n_clients > 0:
            assert 1 <= self.cohort_k <= self.n_clients, (
                f"cohort_k={self.cohort_k} not in "
                f"[1, n_clients={self.n_clients}]")
            assert self.cohort_k == self.m, (
                f"federated spec: m={self.m} must equal "
                f"cohort_k={self.cohort_k} — the sim's worker slots hold "
                f"the sampled cohort")
            assert self.max_staleness == 0 and not self.elastic, \
                "federated rounds are server-synchronous: no staleness, " \
                "no elastic membership (churn comes from availability)"
        else:
            assert self.cohort_k == 0, \
                "cohort_k without n_clients — set both or neither"

    # ---- derived models ---------------------------------------------------- #
    @property
    def link(self) -> LinkModel:
        return LinkModel(alpha=self.alpha, beta=1.0 / self.bandwidth)

    @property
    def collective_model(self) -> CollectiveModel:
        topo = self.topology
        return CollectiveModel(
            link=self.link, kind=self.collective,
            pods=topo.pods if topo is not None else 1,
            inter_link=topo.inter_link if topo is not None else None)

    def collective_time(self, nbytes: float, w: Optional[int] = None) -> float:
        """Time of one all-reduce of ``nbytes`` over ``w`` workers (defaults
        to the full membership ``m``; elastic runs pass the live count)."""
        return self.collective_model.all_reduce_time(
            nbytes, self.m if w is None else w)

    @property
    def sampling(self):
        """The ``core.federated.ClientSampling`` spec of a federated
        cluster (``n_clients > 0``), seeded by the cluster seed — the ONE
        cohort schedule the round executor and the replay both draw from.
        None on a conventional (always-on) cluster."""
        if self.n_clients <= 0:
            return None
        from repro_torch.core.federated import ClientSampling
        return ClientSampling(self.n_clients, self.cohort_k, seed=self.seed,
                              availability=self.availability)

    def speeds(self) -> Tuple[float, ...]:
        return self.rel_speeds if self.rel_speeds else (1.0,) * self.m

    def with_(self, **kw) -> "ClusterSpec":
        return replace(self, **kw)

    # ---- seeded draws (all randomness enters the sim here) ----------------- #
    def rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)

    def draw_slowdowns(self, rng: np.random.Generator) -> np.ndarray:
        """(m,) multiplicative time factors for one iteration — combines the
        persistent ``rel_speeds`` with this iteration's straggler/jitter
        draws.  Draw order is fixed (jitter, then stragglers, workers in
        index order) so the trace is reproducible."""
        mult = np.ones(self.m)
        if self.jitter_sigma > 0:
            mult *= rng.lognormal(0.0, self.jitter_sigma, self.m)
        if self.straggler_prob > 0:
            hit = rng.random(self.m) < self.straggler_prob
            mult = np.where(hit, mult * self.straggler_slowdown, mult)
        return mult / np.asarray(self.speeds())

    def draw_failure_gap(self, rng: np.random.Generator) -> float:
        """Seconds until the next failure (inf when failures are off)."""
        if self.fail_rate <= 0:
            return math.inf
        return float(rng.exponential(1.0 / self.fail_rate))

    def draw_downtime(self, rng: np.random.Generator) -> float:
        """Seconds an elastically-failed worker stays out of the membership
        (seeded exponential with mean ``downtime``)."""
        return float(rng.exponential(self.downtime))


def bandwidth_constrained(m: int = 4, *, seed: int = 0,
                          bandwidth: float = 1e5,
                          alpha: float = 1e-5,
                          flops_per_sec: float = 1e9,
                          **kw) -> ClusterSpec:
    """The paper's target regime: links are the bottleneck, compute is not.

    A d-dim fp32 all-reduce costs ``4*d/bandwidth`` — orders of magnitude
    above both the per-collective latency and a function evaluation — which
    is exactly when amortizing FO exchanges over tau ZO iterations pays.
    Extra ``kw`` pass through to ``ClusterSpec`` (collective, topology,
    max_staleness, elastic, ...)."""
    return ClusterSpec(m=m, flops_per_sec=flops_per_sec, alpha=alpha,
                       bandwidth=bandwidth, seed=seed, **kw)
