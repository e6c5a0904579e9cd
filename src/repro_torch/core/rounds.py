"""Round-program IR, in PyTorch: a method as a schedule of per-worker rounds.

Counterpart of ``repro.core.rounds`` (README §RoundProgram).  A method is
``init(params) -> state`` plus a host-side schedule ``round_for(t, state) ->
RoundStep`` picking this iteration's ``Round``; each ``Round`` is a
per-worker ``local(t, worker, model, shard) -> (payload, aux)``, a
collective (``all_reduce``, ``all_gather``, ``tree_average``,
``masked_average``, ``neighbor_exchange`` or ``none``) with a wire codec hook
(``Wire``), and ``apply(t, params, state, reduced, workers, aux)``, which
commits the reduced payload.  ``core.baselines`` builds PA/RI/QSGD (and
gossip-PA) as round programs, and ``ho_sgd_program`` is HO-SGD's.

Wire accounting follows the ``CommLedger`` receive convention (bytes
received per worker per collective), in one place, ``wire_nbytes``:

  * ``all_gather``  — bytes of the gathered result: payload × n_active;
  * ``all_reduce``  — dense: bytes of the reduced payload; with a
    per-worker codec ``codec.nbytes`` × n_active; legacy ``codec.nbytes``;
  * ``tree_average`` — as ``all_reduce``, over the model tree;
  * ``masked_average`` — per-client payload bytes × n_active;
  * ``neighbor_exchange`` — min(2, W-1) neighbor payloads per worker;
  * ``none`` — 0.

The executor returns that count as ``metrics["comm_bytes"]`` and books it
through ``dist.collectives.note``, so a ledger-wrapped run records the same
number.

What differs from the reference: the reference evaluates the locals under
one ``jax.jit(jax.vmap(local))`` cached per ``Round`` object; the port's
``RoundExecutor`` calls the local once per live worker, in worker order, and
stacks the payloads -- the same values per worker, and no compiled state to
cache (the test that pins the reference's cache keying pins here that a
rebuilt round's own local runs).  Steps and worker ids are Python ints; a
random key is a uint32 int (``dist.compress``).  A program with
``client_sampling`` (``core.federated.ClientSampling``) runs each round over
its live cohort, every client on its own identity-keyed shard.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import directions as D
from repro_torch.core.ho_sgd import (
    Method, _device_of, _split_workers, engine_cache, to_device, value_and_grad)
from repro_torch.dist import collectives as coll
from repro_torch.dist import compress as compress_mod
from repro_torch.dist.collectives import _tree_nbytes
from repro_torch.opt.optimizers import apply_deltas, const_schedule, sgd
from repro_torch.tree import tree_leaves, tree_map

#: collective ops a Round may request (the executor's reduce semantics)
COLLECTIVES = ("all_reduce", "all_gather", "tree_average", "masked_average",
               "neighbor_exchange", "none")

#: collectives a ``Wire`` codec composes with (``all_gather`` moves raw
#: payloads and ``none`` moves nothing: a codec there would book dense bytes)
CODEC_COLLECTIVES = ("all_reduce", "tree_average", "masked_average",
                     "neighbor_exchange")

#: wire codec application modes
WIRE_MODES = ("per_worker", "legacy")


@dataclass(frozen=True)
class Wire:
    """How a round's payload crosses the wire.

    ``per_worker`` encodes every worker's payload independently and decodes
    at the reducer (per-worker wire bytes = ``codec.nbytes`` × active
    workers); ``legacy`` decodes ``encode(mean)`` after the reduction,
    booked at one worker's bytes.  ``seed`` roots the encode keys: worker w
    at step t uses ``fold(fold(seed, t), w)``, keyed on the worker's
    identity, not its position in the live membership.
    """

    codec: Optional[compress_mod.Compressor] = None
    mode: str = "per_worker"
    seed: int = 0

    def __post_init__(self):
        if self.mode not in WIRE_MODES:
            raise ValueError(f"unknown wire mode {self.mode!r}; have {WIRE_MODES}")


@dataclass(frozen=True)
class Overlap:
    """Compute/communication overlap spec: ``buckets > 1`` lets bucket k's
    collective overlap the compute of chunk k+1.  It changes time only,
    never bytes; on one card nothing is overlapped, and the spec is kept for
    the schedule's pricing (the simulator's port)."""

    buckets: int = 1

    def __post_init__(self):
        if self.buckets < 1:
            raise ValueError(f"overlap buckets must be >= 1, got {self.buckets}")

    @property
    def enabled(self) -> bool:
        return self.buckets > 1

    @property
    def overlappable_fraction(self) -> float:
        return (self.buckets - 1) / self.buckets


@dataclass(frozen=True, eq=False)
class Round:
    """One per-worker round: local computation + collective + apply.

    ``eq=False`` keeps object identity for ``__eq__``/``__hash__``: a round
    is the object itself, never a structurally equal copy.

    ``local(t, worker, model, shard) -> (payload, aux)`` runs on each
    participating worker; ``model`` is the global params, or the worker's own
    replica (``state["replicas"]``) when ``replica=True``.  ``aux`` is a
    monitoring scalar (booked ``payload=False``).  ``apply(t, params, state,
    reduced, workers, aux)`` commits the round: ``workers`` is the list of
    contributing worker ids, ``aux`` the worker-stacked aux values.
    ``meta`` carries the configuration the round was made with (opaque to
    the executor).
    """

    tag: str
    order: int                       # 1 = gradient round, 0 = function-eval
    collective: str
    local: Callable[..., Tuple[Any, Any]]
    apply: Callable[..., Tuple[Any, Any, Dict[str, Any]]]
    wire: Wire = field(default_factory=Wire)
    replica: bool = False
    meta: Any = None
    overlap: Overlap = field(default_factory=Overlap)

    def __post_init__(self):
        if self.collective not in COLLECTIVES:
            raise ValueError(f"unknown collective {self.collective!r}; "
                             f"have {COLLECTIVES}")
        if self.wire.codec is not None and self.collective not in CODEC_COLLECTIVES:
            raise ValueError(
                f"a Wire codec ({self.wire.codec.name!r}) is not supported on "
                f"collective {self.collective!r}: codecs compose with "
                f"{CODEC_COLLECTIVES}")
        if self.collective == "masked_average" and self.wire.mode != "per_worker":
            raise ValueError("masked_average is per-client: the legacy wire mode "
                             "has no meaning there")


class RoundStep(NamedTuple):
    """One scheduled iteration: the round, the iteration index to run it at
    (``t_step``) and host-side state updates merged after ``apply``."""

    round: Round
    t_step: int
    host_updates: Dict[str, Any]


@dataclass(frozen=True)
class RoundProgram:
    """A method as ``init`` + a schedule of per-worker rounds.

    ``round_for(t, state)`` is a pure host-side function; ``prepare(t, batch,
    key)`` optionally transforms the global batch before sharding (RI-SGD's
    redundancy mixing); ``comm_scalars``/``fevals``/``gevals`` are the
    Table-1 analytic cost hooks (``Method`` compatibility).

    ``client_sampling`` (a ``core.federated.ClientSampling``) makes the
    program federated: ``m`` must equal the spec's ``cohort_k`` (the worker
    slots are the sampled cohort), and the executor draws each round's live
    cohort from the spec, feeding every client its own identity-keyed shard.
    """

    name: str
    m: int
    init: Callable[[Any], Any]
    round_for: Callable[[int, Any], RoundStep]
    comm_scalars: Callable[[int], float]
    fevals: Callable[[int], float]
    gevals: Callable[[int], float]
    prepare: Optional[Callable[[int, Any, Any], Any]] = None
    client_sampling: Any = None

    def __post_init__(self):
        if self.client_sampling is not None and self.client_sampling.cohort_k != self.m:
            raise ValueError(
                f"federated program {self.name!r}: m={self.m} must equal cohort_k="
                f"{self.client_sampling.cohort_k} (the worker slots are the cohort)")


# --------------------------------------------------------------------------- #
# shared helpers
# --------------------------------------------------------------------------- #
#: (m*B, ...) -> (m, B, ...) on every leaf (worker i owns row i)
split_shards = _split_workers


def _stack_trees(trees: Sequence[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _slice_tree(tree: Any, idx) -> Any:
    return tree_map(lambda x: x[idx], tree)


def payload_nbytes(payload_slice: Any) -> int:
    """Dense wire bytes of ONE worker's payload tree."""
    return _tree_nbytes(payload_slice)


def codec_nbytes(codec: compress_mod.Compressor, payload_slice: Any) -> int:
    """Codec wire bytes of ONE worker's payload tree (per-leaf wire model)."""
    return sum(codec.nbytes(int(x.numel())) for x in tree_leaves(payload_slice))


def wire_nbytes(rnd: Round, payload_slice: Any, n_active: int) -> int:
    """Bytes received per worker for this round's collective."""
    if rnd.collective == "none" or n_active <= 0:
        return 0
    dense = payload_nbytes(payload_slice)
    codec = rnd.wire.codec
    if rnd.collective == "all_gather":
        return dense * n_active
    if rnd.collective in ("all_reduce", "tree_average"):
        if codec is None:
            return dense
        per = codec_nbytes(codec, payload_slice)
        return per * (n_active if rnd.wire.mode == "per_worker" else 1)
    per = dense if codec is None else codec_nbytes(codec, payload_slice)
    if rnd.collective == "masked_average":
        return per * n_active
    return per * min(2, n_active - 1)              # neighbor_exchange


def neighbor_mix(stacked: Any, n_active: int) -> Any:
    """Ring-gossip mixing over the active workers in listed order: worker
    j's result is ``(P[j-1] + P[j] + P[j+1]) / 3`` (with two workers the
    single neighbor, with one itself); fp32 accumulation, cast back."""
    if n_active == 1:
        return stacked

    def mix(x):
        x32 = x.to(torch.float32)
        left = torch.roll(x32, 1, dims=0)
        right = torch.roll(x32, -1, dims=0)
        if n_active == 2:          # left and right are the same worker
            out = (x32 + left) / 2.0
        else:
            out = (left + x32 + right) / 3.0
        return out.to(x.dtype)

    return tree_map(mix, stacked)


def masked_average(stacked: Any, weights) -> Tuple[Any, Any]:
    """FedDropoutAvg's masked weighted average over a worker-stacked tree:
    per coordinate ``sum_c w_c*x_c / sum_c w_c*[x_c != 0]`` (a zero value is
    an absent value).  Returns ``(avg, wsum)``; where ``wsum == 0`` the
    average is 0.  fp32 accumulation, cast back."""

    def num_den(x):
        x32 = x.to(torch.float32)
        w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
        wb = w.reshape((w.shape[0],) + (1,) * (x32.dim() - 1))
        num = torch.sum(x32 * wb, dim=0)
        den = torch.sum(torch.where(x32 != 0, wb, torch.zeros_like(wb)), dim=0)
        return num, den

    def avg_leaf(x):
        num, den = num_den(x)
        pos = den > 0
        out = torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                          torch.zeros_like(num))
        return out.to(x.dtype)

    return tree_map(avg_leaf, stacked), tree_map(lambda x: num_den(x)[1], stacked)


def _wire_key(wire: Wire, key, t) -> int:
    return D.fold(wire.seed if key is None else key, t)


def wire_roundtrip(wire: Wire, stacked: Any, workers: Sequence[int], key_t) -> Any:
    """Per-worker encode + reducer decode of a worker-stacked payload tree,
    worker w keyed ``fold(key_t, w)``; a no-op without a codec or in legacy
    mode (legacy decodes after the reduction instead)."""
    if wire.codec is None or wire.mode != "per_worker":
        return stacked
    outs = []
    for j, w in enumerate(workers):
        dec, _ = compress_mod.compress_tree(wire.codec, _slice_tree(stacked, j),
                                            D.fold(key_t, int(w)))
        outs.append(dec)
    return _stack_trees(outs)


def reduce_payloads(rnd: Round, stacked: Any, workers: Sequence[int], key_t,
                    weights=None) -> Any:
    """The wire codec and the round's collective applied to a worker-stacked
    payload tree: what ``apply`` receives as ``reduced``.  ``weights``
    (default uniform) matters only for ``masked_average``."""
    n_active = len(workers)
    if rnd.collective in ("none", "all_gather"):
        return stacked
    stacked = wire_roundtrip(rnd.wire, stacked, workers, key_t)
    if rnd.collective == "neighbor_exchange":
        return neighbor_mix(stacked, n_active)
    if rnd.collective == "masked_average":
        return masked_average(stacked, [1.0] * n_active if weights is None else weights)
    # all_reduce / tree_average: mean over the contributing workers
    mean = tree_map(lambda x: torch.mean(x.to(torch.float32), 0).to(x.dtype), stacked)
    if rnd.wire.codec is not None and rnd.wire.mode == "legacy":
        mean, _ = compress_mod.compress_tree(rnd.wire.codec, mean, key_t)
    return mean


# --------------------------------------------------------------------------- #
# the executor
# --------------------------------------------------------------------------- #
class RoundExecutor:
    """Runs a ``RoundProgram`` one round at a time, per worker.

    ``run(t, params, state, batch, workers=..., views=..., key=...)``
    executes one scheduled round over any subset of workers (``workers``,
    the live membership, default all ``m``, or the round's sampled cohort
    under ``client_sampling``), optionally feeding each worker
    its own stale model view (``views``: worker -> params).  The batch is
    moved to the parameters' device first.  Byte accounting: the round's wire
    bytes land in ``metrics["comm_bytes"]`` and are booked with
    ``dist.collectives.note`` (a no-op outside a ``CommLedger.wrap``).
    """

    def __init__(self, prog: RoundProgram):
        self.prog = prog

    @torch.no_grad()
    def run(self, t: int, params: Any, state: Any, batch: Any, *,
            workers: Optional[Sequence[int]] = None,
            views: Optional[Dict[int, Any]] = None,
            key=None) -> Tuple[Any, Any, Dict[str, Any]]:
        prog = self.prog
        step = prog.round_for(t, state)
        rnd, t_step = step.round, step.t_step
        batch = to_device(batch, _device_of(params))
        if prog.prepare is not None:
            batch = prog.prepare(t, batch, key)
        cs = prog.client_sampling
        if cs is not None and (rnd.replica or views is not None):
            raise ValueError("client-sampling rounds keep one server model: no "
                             "replicas and no stale views")
        if workers is not None:
            ws = [int(w) for w in workers]
        else:
            ws = list(range(prog.m)) if cs is None else list(cs.cohort_for(t))
        if not ws:
            raise ValueError("a round needs at least one participating worker")

        weights = None
        if cs is not None:
            # federated: each live client on its own identity-keyed shard;
            # the masked-average weights are the clients' dataset sizes
            from repro_torch.core.federated import cohort_shards

            shards = cohort_shards(batch, ws, t, cs)
            outs = [rnd.local(t_step, w, params, _slice_tree(shards, j))
                    for j, w in enumerate(ws)]
            if rnd.collective == "masked_average":
                weights = cs.client_weights(ws)
        else:
            shards = split_shards(batch, prog.m)
            outs = []
            for w in ws:
                if rnd.replica:
                    model = _slice_tree(state["replicas"], w)
                elif views is not None:
                    model = views.get(w, params)
                else:
                    model = params
                outs.append(rnd.local(t_step, w, model, _slice_tree(shards, w)))
        payloads = _stack_trees([p for p, _ in outs])
        aux = None if outs[0][1] is None else torch.stack([a for _, a in outs])

        nbytes = wire_nbytes(rnd, _slice_tree(payloads, 0), len(ws))
        reduced = reduce_payloads(rnd, payloads, ws, _wire_key(rnd.wire, key, t_step),
                                  weights=weights)
        if nbytes:
            coll.note(rnd.collective, None, nbytes=nbytes, tag=rnd.tag)
        if aux is not None:
            coll.note("pmean", None, nbytes=4, tag="loss", payload=False)

        params, state, metrics = rnd.apply(t_step, params, state, reduced, ws, aux)
        if step.host_updates:
            state = {**state, **step.host_updates}
        metrics = dict(metrics)
        metrics.setdefault("order", rnd.order)
        metrics["comm_bytes"] = nbytes
        metrics["n_live"] = len(ws)
        return params, state, metrics


def to_method(prog: RoundProgram) -> Method:
    """A ``RoundProgram`` as a ``Method``: each step runs the scheduled round
    over all ``m`` workers through a ``RoundExecutor``."""
    ex = RoundExecutor(prog)

    def step(t, params, state, batch, key=None):
        return ex.run(t, params, state, batch, key=key)

    return Method(prog.name, prog.init, step, prog.comm_scalars, prog.fevals,
                  prog.gevals, program=prog)


# --------------------------------------------------------------------------- #
# the HO-SGD family as a round program
# --------------------------------------------------------------------------- #
def fo_round(loss_fn: Callable, opt, *, wire: Optional[Wire] = None,
             overlap: Optional[Overlap] = None) -> Round:
    """Eq. (3): each worker's shard gradient, all-reduce mean, optimizer
    update."""

    def local(t, worker, model, shard):
        loss, grads = value_and_grad(loss_fn, model, shard)
        return grads, loss

    def apply(t, params, state, reduced, workers, aux):
        deltas, opt_state = opt.update(reduced, state["opt"], params, t)
        return (apply_deltas(params, deltas), {**state, "opt": opt_state},
                {"loss": torch.mean(aux)})

    return Round("fo", 1, "all_reduce", local, apply, wire=wire or Wire(),
                 meta={"loss_fn": loss_fn, "opt": opt},
                 overlap=overlap or Overlap())


def zo_round(loss_fn: Callable, ho, opt, *, m: Optional[int] = None,
             overlap: Optional[Overlap] = None) -> Round:
    """Eq. (4)-(6): each worker's directional-derivative scalar in its
    pre-shared direction, all-gathered; the update is reconstructed from the
    coefficients of the workers that contributed, divided by their count."""
    engine_for = engine_cache(ho.engine, ho.seed, ho.acc_dtype)

    def local(t, worker, model, shard):
        return engine_for(model).zo_coeff(loss_fn, model, shard, t, worker, ho.mu)

    def apply(t, params, state, reduced, workers, aux):
        rec = engine_for(params).reconstruct(reduced, t, workers)
        g_hat = tree_map(lambda a: a * (ho.zo_scale / len(workers)), rec)
        deltas, opt_state = opt.update(g_hat, state["opt"], params, t)
        return (apply_deltas(params, deltas), {**state, "opt": opt_state},
                {"loss": torch.mean(aux)})

    return Round("zo", 0, "all_gather", local, apply,
                 meta={"loss_fn": loss_fn, "ho": ho, "opt": opt, "m": m},
                 overlap=overlap or Overlap())


def ho_sgd_program(
    loss_fn: Callable,
    ho,
    opt=None,
    *,
    name: str = "ho_sgd",
    wire: Optional[Wire] = None,
    tau_schedule: Optional[Callable[[int], int]] = None,
    zo_only: bool = False,
    overlap: Optional[Overlap] = None,
    client_sampling: Any = None,
) -> RoundProgram:
    """HO-SGD (Algorithm 1) as a round program: FO sync rounds every tau
    iterations (or per ``tau_schedule`` through ``adaptive_tau_decision``),
    ZO rounds in between; ``zo_only`` never syncs.  State is
    ``{"opt": ..., "since_fo": int}``.  ``client_sampling``
    (``core.federated.ClientSampling``, ``cohort_k == ho.m``) makes it
    federated: every round runs over a freshly sampled cohort, and client
    c's direction at round t is keyed on c, whoever else was sampled."""
    from repro_torch.core.ho_sgd import adaptive_tau_decision

    opt = opt or sgd(const_schedule(ho.lr), ho.momentum)
    fo = fo_round(loss_fn, opt, wire=wire, overlap=overlap)
    zo = zo_round(loss_fn, ho, opt, m=ho.m, overlap=overlap)

    def init(params):
        return {"opt": opt.init(params), "since_fo": 0}

    def round_for(t: int, state) -> RoundStep:
        if zo_only:
            return RoundStep(zo, t, {"since_fo": int(state["since_fo"]) + 1})
        if tau_schedule is not None:
            is_fo, t_step, since = adaptive_tau_decision(
                t, int(state["since_fo"]), tau_schedule(t), ho.tau)
            return RoundStep(fo if is_fo else zo, t_step, {"since_fo": since})
        is_fo = t % ho.tau == 0
        since = 0 if is_fo else int(state["since_fo"]) + 1
        return RoundStep(fo if is_fo else zo, t, {"since_fo": since})

    tau = max(1, ho.tau)
    return RoundProgram(
        name, ho.m, init, round_for,
        comm_scalars=lambda d: (d + (tau - 1)) / tau,
        fevals=lambda d: 2.0 * (tau - 1) / tau,
        gevals=lambda d: 1.0 / tau,
        client_sampling=client_sampling,
    )
