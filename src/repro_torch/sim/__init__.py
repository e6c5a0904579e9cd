"""repro_torch.sim — discrete-event cluster simulator for the paper's tradeoff.

Counterpart of ``repro.sim``, with the same exports: the event core, the
cost models and the cluster spec are copies (host arithmetic and numpy
draws), and the runner and the traffic replay drive the port's own step
programs and serving engine.  Simulated seconds, tokens per second and TTFT
are outputs of the FLOP and alpha–beta models (``ClusterSpec.flops_per_sec``,
``serve_compute_model``'s rate), not times measured on a device.

Turns the three incommensurable cost axes (CommLedger bytes, function
evals, loss-vs-iteration) into one: time to target loss on a configurable
simulated cluster.  The scenario substrate for stragglers, heterogeneity,
elastic clusters and failures — extend ``ClusterSpec``/``simulate`` here
the way ``repro_torch.dist`` owns sharding and ``DirectionEngine`` owns ZO
algebra.

  * ``events``  — deterministic event loop, per-worker clocks, the
    barriered all-reduce primitive and its bounded-staleness async twin,
    plus the shared-link contention resources (``SharedLink`` /
    ``LinkContention``) that serialize concurrent unbarriered transfers
    in deterministic (time, worker) order.
  * ``costs``   — pluggable hardware cost models (FLOP-based compute,
    alpha–beta links, ``CollectiveModel`` pricing flat/ring/tree/gossip
    and hierarchical multi-pod all-reduces, overlap-aware exposed-comm
    pricing via ``exposed_comm_time``); byte counts always come from
    the ``CommLedger`` / the round IR's wire model (``rounds.wire_nbytes``
    over ``dist.compress`` estimates), never re-derived.
  * ``cluster`` — ``ClusterSpec``: heterogeneous speeds, seeded straggler
    distributions, Poisson failures charged a real checkpoint-restore,
    ``Topology`` (pods × workers-per-pod), ``max_staleness`` async and
    ``elastic`` leave/rejoin membership.
  * ``runner``  — replays the real round programs from ``core.rounds`` /
    ``core.baselines`` (per worker by default: elastic membership and
    bounded staleness change the trajectory, not just the price;
    ``replay="monolithic"`` keeps the pricing-only behavior) and
    emits loss-vs-simulated-seconds traces.
  * ``traffic`` — open-loop serving workloads: seeded Poisson arrivals
    with prompt/output-length mixes replayed against the REAL
    ``repro_torch.serving`` scheduler, each step priced by ``ComputeModel``
    (prefill = bucket tokens, decode = live slots), emitting tokens/sec
    and p50/p99 TTFT/latency under the same determinism contract.
"""
from repro_torch.sim.cluster import (  # noqa: F401
    ClusterSpec,
    Topology,
    bandwidth_constrained,
)
from repro_torch.sim.costs import (  # noqa: F401
    COLLECTIVE_KINDS,
    CollectiveModel,
    ComputeModel,
    LinkModel,
    StepCost,
    config_fwd_flops,
    exposed_comm_time,
    flat_all_reduce_time,
    gossip_exchange_time,
    overlapped_step_time,
    ring_all_reduce_time,
    tree_all_reduce_time,
    tree_fwd_flops,
)
from repro_torch.sim.events import (  # noqa: F401
    EventLoop,
    LinkContention,
    SharedLink,
    WorkerClocks,
    async_all_reduce,
    barrier_all_reduce,
)
from repro_torch.sim.runner import (  # noqa: F401
    SimMethod,
    SimResult,
    compute_model_for,
    make_sim_methods,
    simulate,
)
from repro_torch.sim.traffic import (  # noqa: F401
    MIXES,
    StepOverheads,
    TrafficResult,
    TrafficSpec,
    poisson_trace,
    replay,
    replay_seed_sync,
    serve_compute_model,
)
