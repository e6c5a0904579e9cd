"""HO-SGD (Algorithm 1) and its two endpoints, in PyTorch.

Counterpart of ``repro.core.ho_sgd``: the single-host implementation in
which the m workers of Algorithm 1 are simulated faithfully (worker i uses
its own batch shard and its own pre-shared-seed direction).

Communication accounting (per worker, per iteration, in scalars):
  * FO iteration: d   (the gradient vector — all-reduce)
  * ZO iteration: 1   (the directional-derivative coefficient)

Steps run eagerly.  The FO step is ``torch.autograd.grad`` over the loss;
the ZO step runs under ``torch.no_grad``.  Batches may be numpy arrays or
tensors; they are moved to the parameters' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import make_engine
from repro_torch.opt.optimizers import Optimizer, apply_deltas, const_schedule, sgd
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class HOSGDConfig:
    tau: int                 # period of first-order updates (tau=1 -> syncSGD)
    mu: float = 1e-3         # smoothing parameter
    m: int = 4               # number of workers
    seed: int = 0            # the pre-shared seed
    lr: float = 0.01
    zo_lr: Optional[float] = None  # ZO-step lr (the paper's attack uses 30/d)
    momentum: float = 0.0
    # dtype of the ZO reconstruction accumulator ('float32' | 'bfloat16')
    acc_dtype: str = "float32"
    # DirectionEngine backend ('tree' | 'fused' | 'pallas' | 'flat';
    # repro_torch.core.engine).  'pallas' runs perturb and reconstruct
    # through the per-leaf CUDA kernels; 'flat' with plain SGD runs the whole
    # ZO round through the flat ones: perturb + norm per worker, then one
    # in-place reconstruct + commit.
    engine: str = "fused"

    @property
    def zo_scale(self) -> float:
        return 1.0 if self.zo_lr is None else self.zo_lr / self.lr

    @property
    def is_first_order_only(self) -> bool:
        return self.tau == 1


class Method(NamedTuple):
    """Uniform optimizer-method interface used by benchmarks and tests."""
    name: str
    init: Callable[[Any], Any]                    # params -> state
    step: Callable[..., tuple]                    # (t, params, state, batch[, key])
    comm_scalars: Callable[[int], float]
    fevals: Callable[[int], float]
    gevals: Callable[[int], float]
    program: Optional[Any] = None


def _split_workers(batch: Any, m: int) -> Any:
    """(m*B, ...) -> (m, B, ...) on every leaf."""
    def r(x):
        if x.shape[0] % m:
            raise ValueError(f"batch {tuple(x.shape)} not divisible by m={m}")
        return x.reshape(m, x.shape[0] // m, *x.shape[1:])
    return tree_map(r, batch)


def to_device(batch: Any, device) -> Any:
    """numpy arrays / tensors -> tensors on ``device``."""
    return tree_map(
        lambda x: (x if isinstance(x, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(x))).to(device),
        batch)


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """``(loss, grads)`` of ``loss_fn`` at ``params`` (``jax.value_and_grad``),
    both detached; the grads are a tree shaped like ``params``.  A leaf the
    loss does not read gets a zero gradient, as ``jax.grad`` gives it (an SSM
    layer's ``norm2``: the model has no feed-forward sublayer to read it)."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        req = [x.detach().requires_grad_(True) for x in leaves]
        with obs.span("fo.forward"):
            loss = loss_fn(tree_unflatten(treedef, req), batch)
        with obs.span("fo.backward"):
            grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


def engine_cache(engine: str, seed: int, acc_dtype: str, specs: Any = None,
                 mesh=None) -> Callable:
    """``params -> DirectionEngine``, built once per tree structure, leaf
    shapes, dtypes and device (an engine holds per-leaf metadata); with
    ``specs`` and ``mesh`` the params are this rank's shards."""
    engines: Dict[Any, Any] = {}

    def engine_for(params):
        leaves, treedef = tree_flatten(params)
        key = (repr(treedef),
               tuple((tuple(x.shape), x.dtype, x.device) for x in leaves))
        if key not in engines:
            engines[key] = make_engine(engine, params, seed, specs=specs, mesh=mesh,
                                       acc_dtype=acc_dtype)
        return engines[key]

    return engine_for


def _unbooked(cs: torch.Tensor, loss: torch.Tensor):
    return cs, loss


def zo_estimate(eng, cs: torch.Tensor, t, zo_scale: float,
                vmap_workers: bool = False) -> Any:
    """Eq. (6): the m directions rebuilt from the m coefficients ``cs`` and
    scaled by ``zo_scale / m``."""
    m = cs.shape[0]
    return tree_map(lambda a: a * (zo_scale / m),
                    eng.reconstruct(cs, t, vmap_workers=vmap_workers))


def zo_round_estimate(eng, loss_fn: Callable, params, batch, t, workers, mu: float,
                      zo_scale: float, exchange: Callable = _unbooked,
                      vmap_workers: bool = False):
    """The generic ZO round up to the optimizer: each worker's coefficient
    on its slice of ``batch`` (stacked (m, B, ...)), ``exchange(cs, loss)``
    (identity here; a lowering books its all-gather through it), then the
    scaled estimate.  Returns ``(g_hat, mean loss)``."""
    cs, f0s = eng.zo_coeffs(loss_fn, params, batch, t, workers, mu,
                            vmap_workers=vmap_workers)
    with obs.span("zo.exchange", kind="comm.exposed"):
        cs, loss = exchange(cs, torch.mean(f0s))
    return zo_estimate(eng, cs, t, zo_scale, vmap_workers), loss


def fused_flat_zo_round(eng, loss_fn: Callable, opt: Optimizer, t, params, opt_state,
                        batch, workers, mu: float, zo_scale: float,
                        exchange: Callable = _unbooked):
    """Single-buffer fused ZO round (engine='flat', plain SGD), returning
    ``(params, opt_state, mean loss)``.

    Each worker's perturb computes the tree-wide ||v||^2 in the same call,
    and the reconstruction + SGD(+momentum) commit is one in-place launch on
    a freshly packed buffer.  ``exchange`` is applied to the stacked
    coefficients and the mean loss, as in ``zo_round_estimate``.  The
    kernel's blockwise sumsq differs in reduction order from the shared one,
    so this path is loss-equivalent -- not bitwise -- to the per-primitive
    engines.
    """
    momentum = float(opt.hyper["momentum"])
    buf = eng.pack(params)
    cs, invs, f0s = [], [], []
    for j, i in enumerate(workers):
        b_i = tree_map(lambda x: x[j], batch)
        with obs.span("zo.loss", point=0, worker=i):
            f0 = loss_fn(params, b_i)
        pbuf, ss = eng.fused_perturb_sumsq(buf, t, i, mu)
        x1 = eng.unpack(pbuf)
        with obs.span("zo.loss", point=1, worker=i):
            f1 = loss_fn(x1, b_i)
        del x1      # as soon as the evaluation is done, as an argument would be
        cs.append(((eng.dim / mu) * (f1 - f0)).to(torch.float32))
        invs.append(torch.rsqrt(ss + 1e-30))
        f0s.append(f0)
    with obs.span("zo.exchange", kind="comm.exposed"):
        cs, loss = exchange(torch.stack(cs), torch.mean(torch.stack(f0s)))
    scaled = cs * torch.stack(invs) * torch.tensor(zo_scale / len(workers),
                                                   dtype=torch.float32)
    lr = opt.hyper["schedule"](t)
    mom = eng.pack(opt_state) if momentum else None
    buf, mom = eng.fused_reconstruct_update(buf, mom, t, workers, scaled, lr, momentum)
    opt_state = eng.unpack(mom, cast=False) if momentum else opt_state
    return eng.unpack(buf), opt_state, loss


def make_ho_sgd(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    cfg: HOSGDConfig,
    opt: Optional[Optimizer] = None,
    name: str = "ho_sgd",
) -> Method:
    opt = opt or sgd(const_schedule(cfg.lr), cfg.momentum)
    engine_for = engine_cache(cfg.engine, cfg.seed, cfg.acc_dtype)

    def fo_step(t, params, opt_state, batch):
        """Eq. (3): all workers' first-order grads, averaged (data-parallel)."""
        flat = tree_map(lambda x: x.reshape(-1, *x.shape[2:]), batch)
        loss, grads = value_and_grad(loss_fn, params, flat)
        with torch.no_grad():
            deltas, opt_state = opt.update(grads, opt_state, params, t)
            return apply_deltas(params, deltas), opt_state, loss

    # The flat engine's fused step path needs introspectable SGD semantics
    # (the momentum update runs in-kernel); any other optimizer — or any
    # other engine — takes the generic reconstruct-then-opt.update path.
    fused_flat = cfg.engine == "flat" and opt.kind == "sgd"

    @torch.no_grad()
    def zo_step(t, params, opt_state, batch):
        """Eq. (4)-(6): per-worker scalar coefficients, shared reconstruction."""
        eng = engine_for(params)
        workers = list(range(cfg.m))
        if fused_flat:
            return fused_flat_zo_round(eng, loss_fn, opt, t, params, opt_state, batch,
                                       workers, cfg.mu, cfg.zo_scale)
        g_hat, loss = zo_round_estimate(eng, loss_fn, params, batch, t, workers,
                                        cfg.mu, cfg.zo_scale)
        deltas, opt_state = opt.update(g_hat, opt_state, params, t)
        return apply_deltas(params, deltas), opt_state, loss

    def init(params):
        return opt.init(params)

    def step(t: int, params, state, batch, key=None):
        batch = _split_workers(to_device(batch, _device_of(params)), cfg.m)
        if t % cfg.tau == 0:
            params, state, loss = fo_step(t, params, state, batch)
            metrics = {"loss": loss, "order": 1}
        else:
            params, state, loss = zo_step(t, params, state, batch)
            metrics = {"loss": loss, "order": 0}
        return params, state, metrics

    def comm_scalars(d: int) -> float:   # amortized per iteration per worker
        return (d + (cfg.tau - 1)) / cfg.tau

    def fevals(d: int) -> float:         # function evals per iter per worker
        return 2 * (cfg.tau - 1) / cfg.tau

    def gevals(d: int) -> float:         # first-order grad evals per iter
        return 1.0 / cfg.tau

    return Method(name, init, step, comm_scalars, fevals, gevals)


def adaptive_tau_decision(t: int, since_fo: int, tau_t: int,
                          base_tau: int) -> tuple:
    """One adaptive-tau scheduling decision: ``(is_fo, t_step, new_since_fo)``.

    FO steps map onto multiples of ``base_tau`` (t=0 always FO); ZO steps map
    t to the t-th positive integer not divisible by ``base_tau`` — injective,
    so no two adaptive ZO steps share a direction seed.
    """
    if base_tau <= 1:
        raise ValueError("adaptive tau needs a base period >= 2")
    if t == 0 or since_fo + 1 >= max(1, int(tau_t)):
        return True, (0 if t == 0 else base_tau * max(t, 1)), 0
    return False, t + 1 + t // (base_tau - 1), since_fo + 1


def parse_tau_schedule(spec: str) -> Callable[[int], int]:
    """``'const:8'`` or ``'linear:2,16,1000'`` -> tau(t)."""
    kind, _, arg = spec.partition(":")
    if kind == "const":
        tau = int(arg)
        if tau < 1:
            raise ValueError(f"const tau must be >= 1, got {tau}")
        return lambda t: tau
    if kind == "linear":
        start, end, horizon = (int(x) for x in arg.split(","))
        if min(start, end, horizon) < 1:
            raise ValueError(spec)
        return lambda t: int(round(start + (end - start) * min(t, horizon)
                                   / horizon))
    raise ValueError(f"unknown tau schedule {spec!r}; use 'const:K' or "
                     f"'linear:start,end,horizon'")


def make_adaptive_ho_sgd(
    loss_fn: Callable,
    cfg: HOSGDConfig,
    tau_schedule: Callable[[int], int],
    opt: Optional[Optimizer] = None,
) -> Method:
    """Beyond-paper: HO-SGD with a time-varying period tau(t).  The since-FO
    counter lives in the method state, so re-initialization restarts the
    schedule."""
    if cfg.tau <= 1:
        raise ValueError("make_adaptive_ho_sgd needs cfg.tau >= 2")
    base = make_ho_sgd(loss_fn, cfg, opt, name="ho_sgd_adaptive")

    def init(params):
        return {"base": base.init(params), "since_fo": 0}

    def step(t: int, params, state, batch, key=None):
        _, t_step, since_fo = adaptive_tau_decision(
            t, int(state["since_fo"]), tau_schedule(t), cfg.tau)
        params, bstate, metrics = base.step(t_step, params, state["base"],
                                            batch, key)
        return params, {"base": bstate, "since_fo": since_fo}, metrics

    return base._replace(name="ho_sgd_adaptive", init=init, step=step)


def make_sync_sgd(loss_fn, m: int, lr: float, momentum: float = 0.0) -> Method:
    """Fully synchronous distributed SGD (Wang & Joshi 2018) = HO-SGD, tau=1."""
    cfg = HOSGDConfig(tau=1, m=m, lr=lr, momentum=momentum)
    meth = make_ho_sgd(loss_fn, cfg, name="sync_sgd")
    return meth._replace(
        comm_scalars=lambda d: float(d), fevals=lambda d: 0.0, gevals=lambda d: 1.0
    )


def make_zo_sgd(loss_fn, m: int, mu: float, lr: float, seed: int = 0) -> Method:
    """Distributed ZO-SGD (Sahu et al. 2019) = HO-SGD, tau >= N (never FO)."""
    cfg = HOSGDConfig(tau=1 << 30, mu=mu, m=m, lr=lr, seed=seed)
    meth = make_ho_sgd(loss_fn, cfg, name="zo_sgd")
    return meth._replace(
        comm_scalars=lambda d: 1.0, fevals=lambda d: 2.0, gevals=lambda d: 0.0
    )


def run_method(
    method: Method,
    params: Any,
    batches,                       # iterable of (m*B, ...) batches
    n_iters: int,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 0,
    key=None,
) -> Dict[str, list]:
    """Simple training loop collecting per-iteration history."""
    state = method.init(params)
    hist: Dict[str, list] = {"loss": [], "order": [], "eval": []}
    it = iter(batches)
    for t in range(n_iters):
        batch = next(it)
        params, state, metrics = method.step(t, params, state, batch, key)
        hist["loss"].append(float(metrics["loss"]))
        hist["order"].append(int(metrics["order"]))
        if eval_fn and eval_every and (t + 1) % eval_every == 0:
            hist["eval"].append((t + 1, float(eval_fn(params))))
    hist["params"] = params
    return hist
