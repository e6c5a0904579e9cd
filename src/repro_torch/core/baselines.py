"""The paper's baselines (Table 1 / §5) as round programs, in PyTorch.

Counterpart of ``repro.core.baselines``:

* PA-SGD — periodic model averaging: each worker runs local SGD on its own
  replica, replicas averaged every tau iterations.
* RI-SGD — PA-SGD where each worker's shard carries a mu_r fraction of its
  peers' data (``ri_shard_batch``).
* Gossip-PA — PA-SGD whose averaging round is a ring ``neighbor_exchange``.
* ZO-SVRG-Ave — zeroth-order SVRG with an epoch anchor over a stored
  dataset; a plain ``Method``, not a round program.  Its directions are the
  hashed sphere directions of ``core.directions`` (plain PyTorch, no kernel).
* QSGD — s-level stochastically quantized gradients through the round IR's
  wire codec (``dist.compress.qsgd``).

Randomness: RI-SGD's redundancy indices and QSGD's stochastic rounding are
``jax.random`` draws in the reference.  Here a key is a uint32 int folded
from the same identities (``core.directions.fold``); RI's indices come from
a CPU ``torch.Generator`` (a few ints per leaf, so the card and the CPU draw
the same ones), QSGD's uniforms from a generator on the gradient's device
(``dist.compress.uniform``).  Each draw is one small function
(``ri_indices``, ``dist.compress.uniform``) apart from what is done with it,
so tests hand the reference's draws to the port.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core import directions as D
from repro_torch.core import rounds as R
from repro_torch.core.ho_sgd import Method, _device_of, to_device, value_and_grad
from repro_torch.core.zo_grad import zo_coefficient
from repro_torch.dist import compress as compress_mod
from repro_torch.tree import tree_map

_F32 = torch.float32


def _sgd_commit(params, grads, lr: float):
    """``(p_f32 - lr * g_f32).to(p.dtype)`` per leaf."""
    return tree_map(lambda p, g: (p.to(_F32) - lr * g.to(_F32)).to(p.dtype),
                    params, grads)


def _set_rows(replicas, rows, workers):
    """Replicas with row ``workers[j]`` replaced by ``rows[j]`` (out of place:
    the caller's state is never written)."""
    def put(r, u):
        idx = torch.as_tensor(workers, dtype=torch.int64, device=r.device)
        return r.index_put((idx,), u.to(r.dtype))
    return tree_map(put, replicas, rows)


# --------------------------------------------------------------------------- #
# PA-SGD / RI-SGD / Gossip-PA (model averaging as round programs)
# --------------------------------------------------------------------------- #
def _pa_rounds(loss_fn, lr: float):
    """The PA-SGD rounds: local SGD (no collective), averaging, and ring
    gossip; all run the same per-replica SGD local."""

    def local(t, worker, model, shard):
        loss, g = value_and_grad(loss_fn, model, shard)
        return _sgd_commit(model, g, lr), loss

    def commit(state, replicas, aux):
        params = tree_map(lambda x: x[0], replicas)
        return params, {**state, "replicas": replicas}, {"loss": torch.mean(aux)}

    def apply_rows(t, params, state, reduced, workers, aux):
        # "none" and neighbor_exchange: reduced is worker-stacked replicas
        return commit(state, _set_rows(state["replicas"], reduced, workers), aux)

    def apply_avg(t, params, state, reduced, workers, aux):
        rows = tree_map(lambda a: a.expand(len(workers), *a.shape), reduced)
        return commit(state, _set_rows(state["replicas"], rows, workers), aux)

    step_rnd = R.Round("pa_local", 1, "none", local, apply_rows, replica=True)
    avg_rnd = R.Round("pa_avg", 1, "tree_average", local, apply_avg, replica=True)
    mix_rnd = R.Round("pa_gossip", 1, "neighbor_exchange", local, apply_rows,
                      replica=True)
    return step_rnd, avg_rnd, mix_rnd


def pa_sgd_program(loss_fn, m: int, tau: int, lr: float, *,
                   name: str = "pa_sgd", gossip: bool = False,
                   prepare=None, gevals: float = 1.0) -> R.RoundProgram:
    step_rnd, avg_rnd, mix_rnd = _pa_rounds(loss_fn, lr)
    sync_rnd = mix_rnd if gossip else avg_rnd

    def init(params):
        return {"replicas": tree_map(
            lambda p: p[None].expand(m, *p.shape).clone(), params)}

    def round_for(t: int, state) -> R.RoundStep:
        synced = (t + 1) % tau == 0
        return R.RoundStep(sync_rnd if synced else step_rnd, t, {})

    # gossip moves min(2, m-1) neighbor models per averaging round instead of
    # the one averaged tree of the all-to-all exchange
    per_sync = float(min(2, m - 1)) if gossip else 1.0
    return R.RoundProgram(
        name, m, init, round_for,
        comm_scalars=lambda d: per_sync * d / tau,
        fevals=lambda d: 0.0,
        gevals=lambda d: gevals,
        prepare=prepare,
    )


def make_pa_sgd(loss_fn, m: int, tau: int, lr: float,
                name: str = "pa_sgd") -> Method:
    return R.to_method(pa_sgd_program(loss_fn, m, tau, lr, name=name))


def make_gossip_pa_sgd(loss_fn, m: int, tau: int, lr: float) -> Method:
    """Decentralized PA-SGD: ring-gossip mixing on the averaging rounds."""
    return R.to_method(pa_sgd_program(loss_fn, m, tau, lr, name="pa_gossip",
                                      gossip=True))


def ri_indices(key: int, m: int, n_red: int, high: int) -> torch.Tensor:
    """RI-SGD's draw: ``(m, n_red)`` sample indices in ``[0, high)`` from a
    CPU generator seeded with ``key`` (the reference's ``randint``)."""
    gen = torch.Generator().manual_seed(int(key))
    return torch.randint(0, high, (m, n_red), generator=gen)


def ri_shard_batch(batch: Any, m: int, mu_r: float, key: int) -> Any:
    """Emulate RI-SGD's redundancy: replace a mu_r fraction of each worker's
    shard with samples drawn from the whole batch (the same indices for
    every leaf of the batch)."""
    def mix(x):
        mB = x.shape[0]
        B = mB // m
        n_red = int(round(mu_r * B))
        if n_red == 0:
            return x
        xs = x.reshape(m, B, *x.shape[1:])
        foreign = x[ri_indices(key, m, n_red, mB).to(x.device)]   # (m, n_red, ...)
        return torch.cat([xs[:, :B - n_red], foreign], dim=1).reshape(x.shape)
    return tree_map(mix, batch)


def make_ri_sgd(loss_fn, m: int, tau: int, lr: float, mu_r: float = 0.25) -> Method:
    def prepare(t, batch, key):
        return ri_shard_batch(batch, m, mu_r, D.fold(t if key is None else key, t))

    # RI-SGD stores (1 + mu_r*m) shards per worker -> higher compute/storage
    return R.to_method(pa_sgd_program(loss_fn, m, tau, lr, name="ri_sgd",
                                      prepare=prepare, gevals=1.0 + mu_r))


# --------------------------------------------------------------------------- #
# ZO-SVRG-Ave (Liu et al., 2018)
# --------------------------------------------------------------------------- #
def make_zo_svrg_ave(
    loss_fn, m: int, mu: float, lr: float, dataset: Any,
    epoch_len: int = 50, seed: int = 0,
) -> Method:
    """RandGradEst averaged over m directions; anchor refreshed per epoch."""

    def zo_est(params, batch, t, salt):
        dim = D.tree_dim(params)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device),
                       params)
        f0_keep = None
        for i in range(m):
            v = D.sphere_direction(params, seed + salt, t, i)
            c, f0 = zo_coefficient(loss_fn, params, batch, v, mu, dim)
            acc = tree_map(lambda a, x: a + c * x.to(_F32), acc, v)
            f0_keep = f0
        return tree_map(lambda a: a / m, acc), f0_keep

    def anchor_grad(params, t):
        return zo_est(params, to_device(dataset, _device_of(params)), t, salt=7)

    @torch.no_grad()
    def init(params):
        g_anchor, _ = anchor_grad(params, 0)
        return {"anchor": params, "g_anchor": g_anchor}

    @torch.no_grad()
    def step(t, params, state, batch, key=None):
        if t % epoch_len == 0 and t > 0:
            g_anchor, _ = anchor_grad(params, t)
            state = {"anchor": params, "g_anchor": g_anchor}
        batch = to_device(batch, _device_of(params))
        g_t, f0 = zo_est(params, batch, t, salt=0)
        g_a, _ = zo_est(state["anchor"], batch, t, salt=0)   # same directions
        vr = tree_map(lambda a, b, c: a - b + c, g_t, g_a, state["g_anchor"])
        params = tree_map(lambda p, g: (p.to(_F32) - lr * g).to(p.dtype), params, vr)
        return params, state, {"loss": f0, "order": 0}

    K = epoch_len
    return Method(
        "zo_svrg_ave", init, step,
        comm_scalars=lambda d: 1.0,
        fevals=lambda d: 4.0 + 2.0 / K,   # two estimates/step + anchor amortized
        gevals=lambda d: 0.0,
    )


# --------------------------------------------------------------------------- #
# QSGD (Alistarh et al., 2017) — through the round IR's wire codec hook
# --------------------------------------------------------------------------- #
def quantize_qsgd(g: torch.Tensor, s: int, key: int) -> torch.Tensor:
    """Unbiased s-level stochastic quantization Q_s(g) of one flat vector (the
    reference quantizer; the method itself rides the ``dist.compress.qsgd``
    codec), rounding up where ``uniform(key) < frac``."""
    norm, sign, q = compress_mod.qsgd_levels(
        g, s, compress_mod.uniform(key, g.shape, g.device))
    return sign.to(_F32) * norm * q.to(_F32) / s


def qsgd_program(loss_fn, m: int, s: int, lr: float, *,
                 compress_mode: str = "per_worker") -> R.RoundProgram:
    codec = compress_mod.qsgd(s)

    def local(t, worker, model, shard):
        loss, g = value_and_grad(loss_fn, model, shard)
        return g, loss

    def apply(t, params, state, reduced, workers, aux):
        return _sgd_commit(params, reduced, lr), state, {"loss": torch.mean(aux)}

    rnd = R.Round("qsgd", 1, "all_reduce", local, apply,
                  wire=R.Wire(codec, compress_mode))

    def init(params):
        return {}

    def round_for(t: int, state) -> R.RoundStep:
        return R.RoundStep(rnd, t, {})

    return R.RoundProgram(
        "qsgd", m, init, round_for,
        comm_scalars=lambda d: (s * s + s * math.sqrt(d)) / 32.0,  # Table 1
        fevals=lambda d: 0.0,
        gevals=lambda d: 1.0,
    )


def make_qsgd(loss_fn, m: int, s: int, lr: float,
              compress_mode: str = "per_worker") -> Method:
    return R.to_method(qsgd_program(loss_fn, m, s, lr, compress_mode=compress_mode))
