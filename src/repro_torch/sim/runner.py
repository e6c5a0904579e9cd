"""Replay the real training steps through the discrete-event cluster model.

Counterpart of ``repro.sim.runner``, replaying the port's step programs with
the reference's event structure, pricing and bookings.  What differs: the
steps run eagerly (the reference jits the HO family's two steps; here the
``CommLedger`` records each call's bookings, so ``costs_for`` reads the bytes
of the last call); the 1x1 mesh of the HO family is made under a world-size-1
gloo group when the caller has none (``launch.mesh.process_group``); checkpoint
round-trips restore onto the parameters' device; steps and keys are Python
ints.  A step never writes its input ``params`` or state in place: the runner
keeps references to them (stale views, the monolithic pending step, the
checkpoints).

``simulate`` drives an actual method one iteration at a time; the event loop
prices each iteration on the simulated cluster — per-worker compute from the
FLOP model, a barriered alpha–beta collective for the exchange — and emits a
loss-vs-simulated-seconds history.  That collapses the paper's three
incommensurable axes (bytes, function evals, loss-vs-iteration) onto one:
time to target loss.

Replay modes (``simulate(..., replay=...)``):

* ``"per_worker"`` (default) — the method's ``repro_torch.core.rounds`` program is
  replayed round by round, PER WORKER: under elastic membership only the
  live workers' shards, coefficients and gradients enter the collective
  (the trajectory genuinely changes, and the live-W collective prices
  exactly the payload each active worker sent), and under bounded
  staleness each async ZO worker evaluates its coefficient at the params
  version it actually had when it started the round.  On a synchronous
  full-membership round every worker's view is current, so the runner
  executes the round through the SAME monolithic step program the
  distributed runtime lowers — the per-worker replay is bit-identical to
  the monolithic one there (``tests/test_replay_fidelity.py``).
* ``"monolithic"`` — the pricing-only replay: the all-m-workers step programs run
  unconditionally and membership/staleness change only pricing and event
  structure, never the computed trajectory (kept for the pricing-only
  contract and as the regression reference).

Byte counts are never re-derived analytically:

* HO-SGD (fixed and adaptive tau), sync-SGD and ZO-SGD replay the
  *distributed* step programs from ``core.distributed`` wrapped in a
  ``CommLedger`` — each synchronous iteration is priced at exactly the
  bytes its compiled program booked (including any FO compressor's wire
  estimate, per-worker or legacy mode).  Per-worker rounds carry their
  bytes out of the round IR's single wire model
  (``rounds.wire_nbytes`` — also what the executor books when wrapped).
* PA-SGD / RI-SGD exchange the model tree itself every tau iterations
  (gossip-PA its ring neighbors' trees); the byte count is measured from
  the live parameter tree.
* QSGD's wire size comes from ``repro_torch.dist.compress.qsgd(s).nbytes`` —
  per-worker mode books ``nbytes`` × active workers (the real protocol),
  ``legacy`` the historical post-reduction single payload.
* Federated methods (``fed_ho_sgd`` / ``fed_avg`` / ``fed_dropout_avg``,
  on a ``ClusterSpec`` with ``n_clients``/``cohort_k``) replay every round
  over a freshly sampled K-of-N client cohort with availability churn; the
  collective is priced and booked at the LIVE cohort (per-client payload ×
  |cohort|, never × N) straight from the executor's wire model.

Failure injection does REAL checkpoint round-trips through
``repro_torch.checkpoint``: the cluster periodically saves ``{params, state}``,
and a failure restores from the latest step — so a lossy method-state
round-trip would corrupt the simulated run, not just a counter.
"""
from __future__ import annotations

import bisect
import math
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint import restore as _restore
from repro_torch.checkpoint import save as ckpt_save
from repro_torch.core import federated as F
from repro_torch.core import rounds as R
from repro_torch.core.baselines import (
    make_gossip_pa_sgd, make_pa_sgd, make_qsgd, make_ri_sgd,
)
from repro_torch.core.distributed import make_fo_step, make_zo_step
from repro_torch.core.ho_sgd import HOSGDConfig, _device_of
from repro_torch.dist import CommLedger
from repro_torch.dist import compress as compress_mod
from repro_torch.dist.collectives import _tree_nbytes
from repro_torch.launch.mesh import make_test_mesh, process_group
from repro_torch.opt.optimizers import Optimizer, const_schedule, sgd
from repro_torch.sim.cluster import ClusterSpec
from repro_torch.sim.costs import (ComputeModel, StepCost, exposed_comm_time,
                                   tree_fwd_flops)
from repro_torch.sim.events import (
    EventLoop,
    LinkContention,
    WorkerClocks,
    barrier_all_reduce,
    commit_async_round,
    plan_async_round,
)
from repro_torch.tree import tree_leaves

REPLAY_MODES = ("per_worker", "monolithic")


def ckpt_restore(ckpt_dir: str, like: Any, step: int):
    """``checkpoint.restore`` onto the device of ``like``'s parameters."""
    return _restore(ckpt_dir, like, step=step, device=_device_of(like["params"]))


@dataclass
class SimMethod:
    """A replayable method: real step functions + per-iteration price tags.

    ``step`` has the ``Method.step`` signature (the monolithic all-m-workers
    program); ``costs_for(t, order)`` prices the iteration that just ran
    (the runner calls it after ``step``, so ledger-backed byte counts are
    always taken from a traced program).  ``program`` is the method's
    ``repro_torch.core.rounds.RoundProgram`` — the per-worker replay handle; the
    runner builds a ``RoundExecutor`` from it and consults
    ``program.round_for`` for the coming round's order (pricing needs it
    before the math runs).
    """

    name: str
    init: Callable[[Any], Any]
    step: Callable[..., tuple]
    costs_for: Callable[[int, int], StepCost]
    ledger: Optional[CommLedger] = None
    program: Optional[R.RoundProgram] = None
    executor: Optional[R.RoundExecutor] = None

    def __post_init__(self):
        if self.program is not None and self.executor is None:
            self.executor = R.RoundExecutor(self.program)

    def order_for(self, t: int, state) -> int:
        assert self.program is not None
        return self.program.round_for(t, state).round.order

    def overlap_for(self, t: int, state) -> int:
        """Bucket count of the coming round's overlap spec (1 = strict
        compute-then-communicate — every round without an explicit
        ``rounds.Overlap`` prices exactly as before)."""
        if self.program is None:
            return 1
        ov = getattr(self.program.round_for(t, state).round, "overlap", None)
        return ov.buckets if ov is not None else 1


@dataclass
class SimResult:
    """Loss-vs-simulated-seconds history plus the committed event trace."""

    name: str
    steps: List[int] = field(default_factory=list)      # iteration index
    times: List[float] = field(default_factory=list)    # completion (sim s)
    losses: List[float] = field(default_factory=list)   # training-batch loss
    orders: List[int] = field(default_factory=list)
    comm_bytes: List[int] = field(default_factory=list)  # wire bytes/worker
    active_counts: List[int] = field(default_factory=list)  # live W/iteration
    feval_cum: List[float] = field(default_factory=list)
    evals: List[Tuple[float, float, float]] = field(default_factory=list)
    #: committed (time, kind, worker) entries — the determinism contract
    trace: List[tuple] = field(default_factory=list)
    #: the committed ``repro_torch.obs`` spans the tuple trace is derived from —
    #: feed to ``repro_torch.obs.export.write_trace`` / ``report.attribution``
    spans: List[Any] = field(default_factory=list)
    compute_s: float = 0.0      # critical-path compute seconds
    comm_s: float = 0.0
    feval_s: float = 0.0        # compute seconds spent on function evals
    geval_s: float = 0.0        # compute seconds spent on gradient evals
    bytes_total: int = 0        # per-worker wire bytes, summed over iters
    failures: int = 0
    rejoins: int = 0            # elastic membership re-entries
    params: Any = None
    state: Any = None           # final method state (opt + counters)

    @property
    def sim_seconds(self) -> float:
        return self.times[-1] if self.times else 0.0

    def _series(self) -> List[Tuple[float, float, float]]:
        """(sim_time, value, feval_seconds) — eval series when present
        (stable held-out loss), else the noisy training-loss series."""
        if self.evals:
            return self.evals
        return list(zip(self.times, self.losses, self.feval_cum))

    def time_to_loss(self, target: float) -> float:
        for t_sim, v, _ in self._series():
            if v <= target:
                return t_sim
        return math.inf

    def feval_seconds_to_loss(self, target: float) -> float:
        for _, v, fs in self._series():
            if v <= target:
                return fs
        return math.inf

    def summary(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "iters": len(self.steps),
            "sim_seconds": self.sim_seconds,
            "compute_s": self.compute_s,
            "comm_s": self.comm_s,
            "feval_s": self.feval_s,
            "geval_s": self.geval_s,
            "bytes_per_worker": self.bytes_total,
            "failures": self.failures,
            "rejoins": self.rejoins,
            "final_loss": self.losses[-1] if self.losses else math.nan,
        }


def compute_model_for(params_like: Any, cluster: ClusterSpec,
                      per_worker_batch: int, *,
                      fwd_flops: Optional[float] = None) -> ComputeModel:
    """Default FLOP pricing for a parameter tree on this cluster."""
    return ComputeModel(
        fwd_flops=(fwd_flops if fwd_flops is not None
                   else tree_fwd_flops(params_like, per_worker_batch)),
        flops_per_sec=cluster.flops_per_sec,
    )


def simulate(
    sm: SimMethod,
    params: Any,
    batches,                      # iterable of (m*B, ...) global batches
    cluster: ClusterSpec,
    n_iters: int,
    *,
    compute: ComputeModel,
    eval_fn: Optional[Callable[[Any], float]] = None,
    eval_every: int = 0,
    target_loss: Optional[float] = None,
    ckpt_dir: Optional[str] = None,
    key=None,
    max_failures: int = 100,
    replay: str = "per_worker",
) -> SimResult:
    """Run ``sm`` for up to ``n_iters`` committed iterations of simulated
    time (early-stop at ``target_loss``); returns the priced history.

    Determinism: same ``cluster`` (seed included), same method, data and
    ``replay`` mode ⇒ bit-identical ``SimResult.trace``.  All randomness
    flows from ``cluster.rng()`` in a fixed draw order (slowdowns are drawn
    for all ``m`` workers even when some have elastically left, so
    membership changes never shift later draws); simulated time never reads
    a wall clock.

    Async (``cluster.max_staleness > 0``): ZO iterations run unbarriered —
    each worker starts a round as soon as it finished its previous one AND
    the round ``max_staleness + 1`` back has committed cluster-wide, and
    (per-worker replay) evaluates its coefficient at the params version it
    actually had at that start time; FO sync rounds always barrier at the
    fully-committed params (HO-SGD's consistency point).  Elastic
    (``cluster.elastic``): a failure removes the victim from the membership
    with NO rollback; the survivors' round re-runs at the live ``W`` — its
    collective priced at the payload those workers actually sent — and the
    victim rejoins after a seeded downtime through a real
    ``repro_torch.checkpoint`` round-trip of the current ``{params, state}``.
    Under ``replay="monolithic"`` membership and staleness change pricing
    and event structure only (the pricing-only contract).
    """
    assert replay in REPLAY_MODES, \
        f"unknown replay mode {replay!r}; have {REPLAY_MODES}"
    use_pw = replay == "per_worker"
    if use_pw:
        assert sm.executor is not None, \
            f"per-worker replay needs a RoundProgram on method {sm.name!r}"
    # federated partial participation: every round runs over a freshly
    # sampled K-of-N client cohort (cluster.sampling's seeded schedule —
    # the same draw the round executor makes), priced at the LIVE cohort
    fed = sm.program.client_sampling if sm.program is not None else None
    if fed is not None:
        assert use_pw, ("federated client-sampling replay needs "
                        "replay='per_worker' (the cohort IS the membership)")
        assert cluster.m == fed.cohort_k, (
            f"cluster m={cluster.m} must equal the program's "
            f"cohort_k={fed.cohort_k}")
        assert cluster.max_staleness == 0 and not cluster.elastic \
            and cluster.fail_rate == 0, \
            "federated rounds are server-synchronous: availability churn " \
            "is the only membership dynamic"
    loop = EventLoop()
    clocks = WorkerClocks.start(cluster.m)
    rng = cluster.rng()
    state = sm.init(params)
    res = SimResult(name=sm.name)
    it = iter(batches)
    if eval_fn is not None and eval_every <= 0:
        eval_every = 1

    tmp = None
    use_ckpt = cluster.ckpt_every > 0
    last_ckpt = 0       # the step THIS run last saved (a caller-supplied
    if use_ckpt or cluster.elastic:   # ckpt_dir may hold stale checkpoints
        if ckpt_dir is None:          # from other runs
            tmp = tempfile.mkdtemp(prefix="repro_sim_ckpt_")
            ckpt_dir = tmp
        if use_ckpt:
            ckpt_save(ckpt_dir, 0, {"params": params, "state": state})
    next_fail = cluster.draw_failure_gap(rng)

    stale = cluster.max_staleness
    # shared-link state for unbarriered exchanges (per-pod + inter-pod);
    # barriered collectives never route through it, so synchronous specs
    # are untouched by the flag
    pods = cluster.topology.pods if cluster.topology is not None else 1
    contention = (LinkContention(cluster.m, pods)
                  if cluster.contention and stale > 0 else None)
    active = list(range(cluster.m))   # live membership, ascending order
    rejoin_at: Dict[int, float] = {}  # left worker -> rejoin time
    pending = None   # monolithic replay: the in-flight (batch consumed)
                     # step, kept across elastic repricing passes so a
                     # failure never skips a batch — there membership
                     # changes the PRICE of iteration t, never its math
    cur_batch = None  # per-worker replay: the iteration's batch, kept
                      # across repricing passes (membership changes which
                      # SHARDS of it enter the round, never skips it)
    # params history for bounded-staleness views: round index -> params
    # after that round committed (-1 = the initial params).  commit_times
    # is the CURRENT LINEAGE's commit times, index-aligned with round t —
    # unlike res.times it is truncated on a bulk-synchronous rollback, so
    # view selection never counts commits of an abandoned lineage
    track_views = use_pw and stale > 0
    phist: Dict[int, Any] = {-1: params} if track_views else {}
    commit_times: List[float] = []

    t = 0
    try:
        while t < n_iters:
            # elastic rejoins whose downtime has elapsed re-enter here (in
            # worker order), through a REAL checkpoint round-trip of the
            # cluster's current state
            if rejoin_at:
                for w in sorted(rejoin_at):
                    back = rejoin_at[w]
                    if back > loop.now:
                        continue
                    del rejoin_at[w]
                    ckpt_save(ckpt_dir, t, {"params": params, "state": state})
                    restored, _ = ckpt_restore(
                        ckpt_dir, {"params": params, "state": state}, step=t)
                    params, state = restored["params"], restored["state"]
                    resume = back + cluster.restart_time
                    loop.record(back, "rejoin", w)
                    loop.record(resume, "restore", w, t0=back)
                    clocks.t[w] = resume
                    active = sorted(active + [w])
                    res.rejoins += 1

            if use_pw:
                if cur_batch is None:
                    cur_batch = next(it)
                order = sm.order_for(t, state)
                sc = sm.costs_for(t, order)
            elif pending is None:
                batch = next(it)
                new_params, new_state, metrics = sm.step(t, params, state,
                                                         batch, key)
                order = int(metrics["order"])
                sc = sm.costs_for(t, order)
                pending = (new_params, new_state, metrics, order, sc)
            else:
                new_params, new_state, metrics, order, sc = pending
            # price the iteration (host floats only; fixed draw order —
            # slowdowns always drawn for all m workers)
            slow = cluster.draw_slowdowns(rng)
            base_dt = compute.time(sc.fevals, sc.gevals)
            dts = [base_dt * float(s) for s in slow]
            is_async = stale > 0 and order == 0
            if is_async:
                idx = len(res.times) - 1 - stale
                gate = res.times[idx] if idx >= 0 else 0.0
            else:
                gate = 0.0

            cohort = None
            if use_pw and fed is not None:
                # federated replay: draw this round's live cohort (the same
                # seeded schedule the executor would draw) and run ONLY the
                # sampled clients; bytes are what the executor's wire model
                # booked for the live cohort, never re-derived
                cohort = list(fed.cohort_for(t))
                new_params, new_state, metrics = sm.executor.run(
                    t, params, state, cur_batch, workers=cohort, key=key)
                comm_bytes = int(metrics["comm_bytes"])
                assert int(metrics["order"]) == order, (sm.name, t, order)
            elif use_pw:
                # per-worker replay: the live membership's rounds run with
                # the params each worker actually has.  On a synchronous
                # full-membership round every view is current, so the round
                # executes through the SAME monolithic step program the
                # runtime lowers (bit-identical replay); divergent views or
                # a shrunken membership force the per-worker path.
                views, lagged = None, False
                if is_async:
                    views = {}
                    for w in active:
                        start_w = max(clocks.t[w], gate)
                        v = bisect.bisect_right(commit_times, start_w)
                        if v < t:               # stale view: after round v-1
                            views[w] = phist[v - 1]
                            lagged = True
                    if not lagged:
                        views = None
                if len(active) == cluster.m and not lagged:
                    new_params, new_state, metrics = sm.step(
                        t, params, state, cur_batch, key)
                    sc = sm.costs_for(t, int(metrics["order"]))
                    comm_bytes = sc.comm_bytes
                else:
                    new_params, new_state, metrics = sm.executor.run(
                        t, params, state, cur_batch, workers=active,
                        views=views, key=key)
                    comm_bytes = int(metrics["comm_bytes"])
                assert int(metrics["order"]) == order, (sm.name, t, order)
            else:
                comm_bytes = sc.comm_bytes

            # overlap-aware pricing: with the round's payload split into B
            # buckets, only the exposed tail of the collective lands on the
            # critical path (costs.exposed_comm_time; B=1 exposes it all —
            # the historical price, bit-identical).  Bytes are whatever the
            # replayed programs booked, never rescaled by overlap.
            cm = cluster.collective_model
            # the round's live membership: the sampled cohort occupies the
            # first len(cohort) worker slots (slot i runs cohort[i]; slowdown
            # draws stay per-SLOT so churn never shifts later draws)
            live = active if cohort is None else list(range(len(cohort)))
            w_live = len(live)
            buckets = sm.overlap_for(t, state)
            dt_crit = max(dts[i] for i in live)
            exposed_crit = exposed_comm_time(cm, comm_bytes, w_live,
                                             buckets, dt_crit)
            entries = trial = None
            if is_async:
                # per-worker exchanges: each worker's exposed time uses its
                # OWN compute (a straggler hides more), split into intra-/
                # inter-pod components so contention routes each through
                # the right shared link
                intra_f, inter_f = cm.time_components(comm_bytes, w_live)
                total_f = intra_f + inter_f

                def comm_for(i):
                    e = exposed_comm_time(cm, comm_bytes, w_live, buckets,
                                          dts[i])
                    if total_f <= 0.0:
                        return 0.0, 0.0
                    return e * intra_f / total_f, e * inter_f / total_f

                entries, trial = plan_async_round(
                    clocks, dts, gate, active, comm_for, contention)
                done_tent = max(e.end for e in entries)
            else:
                done_tent = max(clocks.t[i] + dts[i]
                                for i in live) + exposed_crit

            if next_fail < done_tent:
                if cluster.elastic:
                    # the victim leaves; survivors continue with NO rollback.
                    # Monolithic replay keeps the in-flight step result and
                    # reprices it at the shrunken membership on the next
                    # pass; per-worker replay re-RUNS the round with the
                    # survivors' shards only (the batch itself is never
                    # skipped).  A failure with one live worker left has
                    # nothing to remove and is not counted — the failures
                    # counter matches leave events.
                    victim = active[int(rng.integers(len(active)))]
                    down = cluster.draw_downtime(rng)
                    if len(active) > 1:
                        loop.record(next_fail, "leave", victim)
                        active = [i for i in active if i != victim]
                        rejoin_at[victim] = next_fail + down
                        # causality: the survivors only learn of the failure
                        # at next_fail (they were waiting on the victim's
                        # barrier slot / exchange), so the re-run round
                        # cannot start — let alone commit — before it
                        for i in active:
                            clocks.t[i] = max(clocks.t[i], next_fail)
                        res.failures += 1
                        if res.failures >= max_failures:
                            break
                    next_fail = next_fail + cluster.draw_failure_gap(rng)
                    continue
                # bulk-synchronous mode: the failure lands inside this
                # iteration, its work is lost; the cluster restores the last
                # checkpoint (a real repro_torch.checkpoint round-trip) and pays
                # the restart charge
                res.failures += 1
                pending = None      # rollback: t changes, the step is stale
                cur_batch = None
                victim = int(rng.integers(cluster.m))
                loop.record(next_fail, "fail", victim)
                restored, rstep = ckpt_restore(
                    ckpt_dir, {"params": params, "state": state},
                    step=last_ckpt)
                params, state = restored["params"], restored["state"]
                t = int(rstep)
                if track_views:
                    # the rounds past the checkpoint belong to an abandoned
                    # lineage: drop their commits from the view index and
                    # resolve any staleness window to the restored params
                    del commit_times[t:]
                    phist = {k: params for k in range(t - 1 - stale, t)}
                resume = next_fail + cluster.restart_time
                loop.record(resume, "restore", t0=next_fail)
                clocks.set_all(resume)
                if res.failures >= max_failures:
                    break
                next_fail = resume + cluster.draw_failure_gap(rng)
                continue

            # commit: drain per-worker compute through the event loop, then
            # the exchange — barriered (FO sync / bulk-synchronous mode,
            # charged its exposed tail) or staleness-gated (async rounds:
            # the planned unbarriered exchanges, adopting the shared-link
            # state only now that the round really lands)
            if is_async:
                if contention is not None and trial is not None:
                    contention.adopt(trial)
                round_start = min(e.start for e in entries)
                done = commit_async_round(loop, clocks, entries,
                                          nbytes=comm_bytes)
                # per-worker overlapped share: full collective minus the
                # exposed tail this worker's own compute could not hide
                total_f = sum(cm.time_components(comm_bytes, w_live))
                for e in entries:
                    hid = total_f - e.comm_s
                    if hid > 1e-15:
                        loop.annotate("comm.overlapped",
                                      max(e.start, e.t_done - hid), e.t_done,
                                      worker=e.worker, name="overlap")
            else:
                round_start = min(clocks.t[i] for i in live)
                done = barrier_all_reduce(loop, clocks, dts, exposed_crit,
                                          active=live, nbytes=comm_bytes)
                if cohort is not None:
                    # server round: every slot resumes at the commit — the
                    # next cohort is dispatched from the committed params
                    clocks.set_all(done)
                # the bucketed collective's hidden share rides behind the
                # round's compute, ending at the barrier point
                hid = cm.all_reduce_time(comm_bytes, w_live) - exposed_crit
                if hid > 1e-15:
                    sync = done - exposed_crit
                    loop.annotate("comm.overlapped",
                                  max(round_start, sync - hid), sync,
                                  name="overlap")
            res.compute_s += dt_crit
            res.comm_s += exposed_crit
            if order == 0:
                res.feval_s += dt_crit
            else:
                res.geval_s += dt_crit
            res.bytes_total += comm_bytes
            params, state = new_params, new_state
            pending = None
            cur_batch = None
            res.steps.append(t)
            res.times.append(done)
            res.losses.append(float(metrics["loss"]))
            res.orders.append(order)
            res.comm_bytes.append(comm_bytes)
            res.active_counts.append(w_live)
            res.feval_cum.append(res.feval_s)
            if track_views:
                phist[t] = params
                for k in [k for k in phist if k < t - stale]:
                    del phist[k]
                commit_times.append(done)
            t += 1

            if use_ckpt and t % cluster.ckpt_every == 0:
                ckpt_save(ckpt_dir, t, {"params": params, "state": state})
                last_ckpt = t
            if eval_fn is not None and t % eval_every == 0:
                v = float(eval_fn(params))
                res.evals.append((done, v, res.feval_s))
                if target_loss is not None and v <= target_loss:
                    break
            elif (eval_fn is None and target_loss is not None
                    and res.losses[-1] <= target_loss):
                break
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    res.trace = list(loop.trace)
    res.spans = list(loop.spans)
    res.params = params
    res.state = state
    return res


# --------------------------------------------------------------------------- #
# method factories
# --------------------------------------------------------------------------- #
def _ho_family(
    loss_fn: Callable,
    cluster: ClusterSpec,
    *,
    name: str,
    tau: int,
    lr: float,
    zo_lr: Optional[float],
    mu: float,
    seed: int,
    opt: Optional[Optimizer] = None,
    codec=None,
    tau_schedule: Optional[Callable[[int], int]] = None,
    zo_only: bool = False,
    engine: str = "fused",
    compress_mode: str = "per_worker",
    overlap_buckets: int = 1,
    device: str = "cuda",
) -> SimMethod:
    """HO-SGD spectrum: the round program (``rounds.ho_sgd_program``) plus
    its monolithic lowering to the real distributed step programs (1x1
    mesh, ``m`` simulated workers in one process — the reference's
    auto-sharded ZO path), wrapped in a ``CommLedger`` so costs_for reads
    measured bytes.  The mesh is made under the caller's process group or
    a world-size-1 one (``launch.mesh.process_group``): only the lowering
    reads it.
    ``overlap_buckets > 1`` attaches a ``rounds.Overlap`` spec to both round
    kinds — the sim prices the exposed comm tail, the lowering chunks the
    gradient reduce, bytes stay bit-identical."""
    with process_group():
        mesh = make_test_mesh(data=1, model=1, device=device)
    ho = HOSGDConfig(tau=tau, mu=mu, m=cluster.m, lr=lr, zo_lr=zo_lr,
                     seed=seed, engine=engine)
    opt = opt or sgd(const_schedule(lr))
    wire = R.Wire(codec, compress_mode, seed=seed)
    overlap = R.Overlap(overlap_buckets) if overlap_buckets > 1 else None
    program = R.ho_sgd_program(loss_fn, ho, opt, name=name, wire=wire,
                               tau_schedule=tau_schedule, zo_only=zo_only,
                               overlap=overlap)
    ledger = CommLedger()
    fo = make_fo_step(loss_fn, mesh, opt, compressor=codec, seed=seed,
                      compress_mode=compress_mode, m=cluster.m,
                      buckets=overlap_buckets)
    zo = make_zo_step(loss_fn, mesh, ho, opt, m=cluster.m)
    fo_j = ledger.wrap("fo", fo)
    zo_j = ledger.wrap("zo", zo)

    # the since-FO counter rides in the sim state so a checkpoint restore
    # also restores the adaptive schedule position
    def init(params):
        return {"opt": opt.init(params), "since_fo": 0}

    def step(t, params, state, batch, key=None):
        # the monolithic lowering of program.round_for's schedule: the FO/ZO
        # decision is the SAME host logic the round program runs
        rstep = program.round_for(t, state)
        is_fo = rstep.round.order == 1
        params, opt_state, loss = (fo_j if is_fo else zo_j)(
            rstep.t_step, params, state["opt"], batch)
        return params, {"opt": opt_state, **rstep.host_updates}, {
            "loss": loss, "order": 1 if is_fo else 0}

    def costs_for(t, order):
        # the FO iteration is one gradient eval; the ZO iteration is two
        # function evals per worker (eq. 4's forward differences) — the
        # per-order resolution of Method.fevals/gevals.  Bytes come from
        # what the traced program booked.
        if order == 1:
            return StepCost(0.0, 1.0, ledger.bytes_per_step("fo"))
        return StepCost(2.0, 0.0, ledger.bytes_per_step("zo"))

    return SimMethod(name, init, step, costs_for, ledger, program=program)


def _averaging_baseline(
    which: str,
    loss_fn: Callable,
    params_like: Any,
    cluster: ClusterSpec,
    *,
    tau: int,
    lr: float,
    mu_r: float = 0.25,
    qsgd_s: int = 8,
    compress_mode: str = "per_worker",
) -> SimMethod:
    d = sum(int(x.numel()) for x in tree_leaves(params_like))
    if which == "pa_sgd":
        meth = make_pa_sgd(loss_fn, cluster.m, tau, lr)
    elif which == "pa_gossip":
        meth = make_gossip_pa_sgd(loss_fn, cluster.m, tau, lr)
    elif which == "ri_sgd":
        meth = make_ri_sgd(loss_fn, cluster.m, tau, lr, mu_r=mu_r)
    elif which == "qsgd":
        meth = make_qsgd(loss_fn, cluster.m, qsgd_s, lr,
                         compress_mode=compress_mode)
    else:
        raise ValueError(which)

    # PA/RI move the model tree itself on averaging rounds (gossip-PA its
    # min(2, m-1) ring neighbors' trees) — bytes measured from the live
    # parameter tree (the ledger's own counter), not a formula on d
    model_bytes = _tree_nbytes(params_like)
    sync_bytes = (model_bytes * min(2, cluster.m - 1)
                  if which == "pa_gossip" else model_bytes)
    # QSGD's wire size: the repo's one QSGD wire model (per-leaf headers);
    # per-worker mode receives every active worker's code (the real
    # protocol), legacy the historical single post-reduction payload
    qsgd_bytes = sum(compress_mod.qsgd(qsgd_s).nbytes(int(x.numel()))
                     for x in tree_leaves(params_like))
    if compress_mode == "per_worker":
        qsgd_bytes *= cluster.m

    def costs_for(t, order):
        fe, ge = meth.fevals(d), meth.gevals(d)
        if which == "qsgd":
            return StepCost(fe, ge, qsgd_bytes)
        synced = (t + 1) % tau == 0
        return StepCost(fe, ge, sync_bytes if synced else 0)

    return SimMethod(which, meth.init, meth.step, costs_for,
                     program=meth.program)


def _federated_family(
    loss_fn: Callable,
    cluster: ClusterSpec,
    *,
    name: str,
    tau: int,
    lr: float,
    zo_lr: Optional[float],
    mu: float,
    seed: int,
    engine: str = "fused",
    codec=None,
    compress_mode: str = "per_worker",
    local_steps: Optional[int] = None,
    fed_dropout: float = 0.25,
) -> SimMethod:
    """The federated frontier's methods, all over the SAME sampled-cohort
    schedule (``cluster.sampling``):

    * ``fed_ho_sgd`` — HO-SGD with sampled-cohort rounds: the cohort's FO
      gradients all-reduce every tau rounds, its ZO coefficients all-gather
      in between (direction streams keyed on client identity survive the
      sampling);
    * ``fed_avg`` — FedAvg-style local-update averaging: each client runs
      ``local_steps`` (default tau) local SGD steps and the server commits
      the dataset-size-weighted ``masked_average`` of the uploaded models;
    * ``fed_dropout_avg`` — FedDropoutAvg: same, but each client zeroes a
      seeded ``fed_dropout`` fraction of its upload and the masked average
      weighs only the coordinates that actually arrived.

    Bytes always come from the round IR's wire model at the LIVE cohort
    (the executor books them; the runner reads ``metrics["comm_bytes"]``),
    so the ``StepCost`` byte slot is intentionally 0 here.
    """
    cs = cluster.sampling
    assert cs is not None, (
        f"{name!r} needs a federated ClusterSpec: set n_clients/cohort_k "
        f"(and m = cohort_k)")
    if name == "fed_ho_sgd":
        ho = HOSGDConfig(tau=tau, mu=mu, m=cluster.m, lr=lr, zo_lr=zo_lr,
                         seed=seed, engine=engine)
        wire = R.Wire(codec, compress_mode, seed=seed)
        program = R.ho_sgd_program(loss_fn, ho, name=name, wire=wire,
                                   client_sampling=cs)

        def costs_for(t, order):
            if order == 1:
                return StepCost(0.0, 1.0, 0)
            return StepCost(2.0, 0.0, 0)
    elif name in ("fed_avg", "fed_dropout_avg"):
        H = local_steps if local_steps is not None else max(1, tau)
        drop = fed_dropout if name == "fed_dropout_avg" else 0.0
        wire = R.Wire(codec, "per_worker", seed=seed)
        program = F.fed_avg_program(loss_fn, cs, lr=lr, local_steps=H,
                                    dropout=drop, seed=seed, wire=wire,
                                    name=name)

        def costs_for(t, order):
            return StepCost(0.0, float(H), 0)
    else:
        raise ValueError(name)
    meth = R.to_method(program)
    return SimMethod(name, meth.init, meth.step, costs_for, program=program)


def make_sim_methods(
    loss_fn: Callable,
    params_like: Any,
    cluster: ClusterSpec,
    *,
    tau: int = 8,
    lr: float = 0.05,
    zo_lr: Optional[float] = None,
    mu: float = 1e-3,
    seed: int = 0,
    codec=None,
    tau_schedule: Optional[Callable[[int], int]] = None,
    mu_r: float = 0.25,
    qsgd_s: int = 8,
    engine: str = "fused",
    compress_mode: str = "per_worker",
    which: Optional[List[str]] = None,
    overlap_buckets: int = 1,
    local_steps: Optional[int] = None,
    fed_dropout: float = 0.25,
) -> Dict[str, SimMethod]:
    """Build the paper's method zoo as replayable ``SimMethod``s.

    ``zo_lr`` defaults to the paper's ``lr * 30 / d`` scaling.  ``codec``
    (a ``repro_torch.dist.Compressor``) compresses the HO/sync FO exchange and is
    priced at its booked wire bytes — ``compress_mode`` picks the faithful
    per-worker encode (``nbytes`` × live workers) or the legacy
    post-reduction simulation.  ``tau_schedule`` drives ``ho_sgd_adaptive``
    (default: linear ramp 2 -> tau over 10*tau iters).  ``overlap_buckets``
    buckets the HO-family collectives (time only, never bytes); the
    averaging baselines keep the strict compute-then-communicate price.

    The ``fed_*`` methods (``fed_ho_sgd``/``fed_avg``/``fed_dropout_avg``)
    need a federated ``cluster`` (``n_clients``/``cohort_k`` set);
    ``local_steps`` (default tau) and ``fed_dropout`` parameterize the
    FedAvg-family local phase — see ``_federated_family``.  ``engine`` is
    one of the port's ``DirectionEngine`` backends (``tree``, ``fused``,
    ``pallas``, ``flat``).
    """
    d = sum(int(x.numel()) for x in tree_leaves(params_like))
    zo_lr = zo_lr if zo_lr is not None else lr * 30.0 / d
    horizon = max(1, 10 * tau)
    sched = tau_schedule or (
        lambda t: int(round(2 + (tau - 2) * min(t, horizon) / horizon)))
    kw = dict(lr=lr, mu=mu, seed=seed, engine=engine,
              device=_device_of(params_like).type,
              compress_mode=compress_mode, overlap_buckets=overlap_buckets)
    fkw = dict(lr=lr, mu=mu, seed=seed, engine=engine,
               compress_mode=compress_mode)
    avg_kw = dict(tau=tau, lr=lr, compress_mode=compress_mode)
    builders: Dict[str, Callable[[], SimMethod]] = {
        "ho_sgd": lambda: _ho_family(
            loss_fn, cluster, name="ho_sgd", tau=tau, zo_lr=zo_lr,
            codec=codec, **kw),
        "ho_sgd_adaptive": lambda: _ho_family(
            loss_fn, cluster, name="ho_sgd_adaptive", tau=tau, zo_lr=zo_lr,
            codec=codec, tau_schedule=sched, **kw),
        "sync_sgd": lambda: _ho_family(
            loss_fn, cluster, name="sync_sgd", tau=1, zo_lr=None,
            codec=codec, **kw),
        "zo_sgd": lambda: _ho_family(
            loss_fn, cluster, name="zo_sgd", tau=max(2, tau), zo_lr=zo_lr,
            zo_only=True, **kw),
        "pa_sgd": lambda: _averaging_baseline(
            "pa_sgd", loss_fn, params_like, cluster, **avg_kw),
        "pa_gossip": lambda: _averaging_baseline(
            "pa_gossip", loss_fn, params_like, cluster, **avg_kw),
        "ri_sgd": lambda: _averaging_baseline(
            "ri_sgd", loss_fn, params_like, cluster, mu_r=mu_r, **avg_kw),
        "qsgd": lambda: _averaging_baseline(
            "qsgd", loss_fn, params_like, cluster, qsgd_s=qsgd_s, **avg_kw),
        "fed_ho_sgd": lambda: _federated_family(
            loss_fn, cluster, name="fed_ho_sgd", tau=tau, zo_lr=zo_lr,
            codec=codec, **fkw),
        "fed_avg": lambda: _federated_family(
            loss_fn, cluster, name="fed_avg", tau=tau, zo_lr=zo_lr,
            codec=codec, local_steps=local_steps, **fkw),
        "fed_dropout_avg": lambda: _federated_family(
            loss_fn, cluster, name="fed_dropout_avg", tau=tau, zo_lr=zo_lr,
            codec=codec, local_steps=local_steps, fed_dropout=fed_dropout,
            **fkw),
    }
    names = which or list(builders)
    unknown = [n for n in names if n not in builders]
    if unknown:
        raise ValueError(f"unknown sim methods {unknown}; have "
                         f"{sorted(builders)}")
    return {n: builders[n]() for n in names}
