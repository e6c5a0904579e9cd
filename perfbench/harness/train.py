"""The training cell: HO-SGD on the port's trainer, steps timed, the first three checked.

Set-up builds the trainer as ``repro_torch.launch.train`` builds it for one
process (a 1 x 1 mesh over a one-rank group, the parameter specs, the
model's loss, ``HOSGDConfig``, SGD, ``make_distributed_ho_sgd``) on the
harness's weights, and drives it through the first ``setup_steps`` steps of
the method's schedule on the traffic's batches: that warms every shape the
window runs and gives the numbers the check compares.  The window then runs
the same objects on: whole periods of ``tau`` consecutive steps (one
first-order step and ``tau - 1`` zeroth-order ones each), a new period
begun while less than ``--seconds`` has passed, each step ending with its
loss on the host.

The check follows the three steps with the plain reference
(``reference.hosgd``) once the window has closed and the program's state is
freed: each step's loss, the first gradient as the optimizer received it,
leaf by leaf, and the change of each leaf after the first step.  A
zeroth-order step is checked by what the program hands out, since in bf16
its coefficient is the loss's rounding noise (PERF.md), which the float32
reference does not share: the model's loss function, which the harness
gives the trainer, records each point the step evaluates (its float32
leaves that start at zero) and each loss.  The losses at both points are
held to the reference's; the second point's offset from the first to the
reference's ``mu v / |v|``; and the step's update of those leaves to
``-zo_lr (d / mu) (f1 - f0) v / |v|``, with the two losses the program
evaluated, the reference's direction and norm, and the harness's own ``d``,
``mu`` and ``zo_lr``.  The change after all three steps is not compared.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from harness import flops, peaks, traffic, weights
from harness.profile import DeviceTimer, Spans, Window, patched


def _zero_leaves(model: Dict):
    return {path for path, _, dt, init, _ in weights.leaf_specs(model)
            if init == "zeros" and dt == torch.float32}


def _points(evals: List) -> List:
    """A ZO step's evaluations as ``[(loss, point)]``, one a point: consecutive
    evaluations at the same point (the batch in parts) give their mean loss."""
    out: List = []
    for loss, point in evals:
        if out and all(torch.equal(point[q], out[-1][1][q]) for q in point):
            out[-1][2].append(float(loss))
        else:
            out.append((None, point, [float(loss)]))
    return [(sum(ls) / len(ls), point) for _, point, ls in out]


def _flat(tree: Dict):
    from reference.decoder import flatten

    return flatten(tree)


def run(ctx) -> Dict:
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import engine as E
    from repro_torch.core.distributed import make_distributed_ho_sgd
    from repro_torch.core.ho_sgd import HOSGDConfig
    from repro_torch.launch.mesh import make_test_mesh, process_group
    from repro_torch.models import transformer as T
    from repro_torch.opt.optimizers import const_schedule, sgd
    from repro_torch.tree import tree_map

    model, mix, dev = ctx.cell.config["model"], ctx.cell.traffic, ctx.device
    cfg = ModelConfig(**model)
    tau, lr, mu = mix["tau"], mix["lr"], mix["mu"]
    n_setup = mix["setup_steps"]
    tokens_per_step = mix["sequences"] * mix["seq_len"]
    out: Dict = {"kind": "train", "tau": tau}
    with process_group():
        mesh = make_test_mesh(data=1, model=1, device=dev.type)
        params = weights.make(model, ctx.seed, dev)
        like = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), params)
        d = sum(x.numel() for _, x in _flat(params))
        ho = HOSGDConfig(tau=tau, mu=mu, m=mix["workers"], lr=lr,
                         zo_lr=lr * mix["zo_lr_scale"] / d, seed=ctx.seed, engine=mix["engine"])
        base = sgd(const_schedule(lr))
        seen: Dict = {"armed": True, "grad_norms": None}

        def update(grads, state, p, t):
            if seen["armed"]:       # the first FO step's gradient, as the optimizer gets it
                seen["grad_norms"] = [float(torch.linalg.vector_norm(g.to(torch.float32)))
                                      for _, g in _flat(grads)]
                seen["armed"] = False
            return base.update(grads, state, p, t)

        opt = base._replace(update=update)
        zero = _zero_leaves(model)
        evals: Dict[int, list] = {}
        heard = {"t": None}

        def loss_fn(p, b):
            loss = T.loss_fn(cfg, p, b, None)
            if heard["t"] is not None:      # a ZO step's evaluation in set-up: its point and loss
                evals.setdefault(heard["t"], []).append(
                    (loss.detach().clone(), {q: x.detach().to(torch.float32).clone()
                                             for q, x in _flat(p) if q in zero}))
            return loss

        fo, zo = make_distributed_ho_sgd(loss_fn, mesh, ho, opt, model_cfg=cfg,
                                         params_like=like)
        opt_state = opt.init(params)
        feed = traffic.train_batches(mix, model["vocab_size"], ctx.seed)
        losses, snaps, changes = [], [], []
        for t in range(n_setup):
            first = t % tau == 0
            heard["t"] = None if first else t
            params, opt_state, loss = (fo if first else zo)(t, params, opt_state, next(feed))
            heard["t"] = None
            losses.append(float(loss))
            snaps.append({p: x.detach().to(torch.float32).clone()
                          for p, x in _flat(params) if p in zero})
            p0 = dict(_flat(weights.make(model, ctx.seed, dev)))
            changes.append([float(torch.linalg.vector_norm(x.to(torch.float32)
                                                           - p0[p].to(torch.float32)))
                            for p, x in _flat(params)])
            del p0
        gc.collect()
        out["setup_s"] = time.perf_counter() - ctx.t_start

        spans, steps = Spans(), []
        sumsq = DeviceTimer()
        traced = ctx.trace and dev.type == "cuda"
        timed = sumsq.wrap(E.DirectionEngine.sumsq) if traced else E.DirectionEngine.sumsq
        t = n_setup
        with patched(E.DirectionEngine, "sumsq", timed), Window(traced) as win:
            while ctx.seconds > 0:              # 0: no window (the limits' readings)
                for _ in range(tau):
                    batch = next(feed)
                    first = t % tau == 0
                    s = time.perf_counter()
                    params, opt_state, loss = (fo if first else zo)(t, params, opt_state, batch)
                    loss = float(loss)                       # waits for the card
                    e = time.perf_counter()
                    kind = "fo_step" if first else "zo_step"
                    spans.add(kind, s, e)
                    steps.append({"t": t, "order": kind, "s": e - s, "tokens": tokens_per_step,
                                  "flops": flops.train_step(model, mix["sequences"],
                                                            mix["seq_len"], first),
                                  "finite": math.isfinite(loss)})
                    t += 1
                if time.perf_counter() - win.t0 >= ctx.seconds:
                    break
        out.update(window_s=win.t1 - win.t0, steps=steps,
                   tokens=sum(s["tokens"] for s in steps), flops=sum(s["flops"] for s in steps),
                   peak_bytes=ctx.peak_bytes())
        if traced:
            out["trace"] = win.summary(spans)
            out["sumsq_ms"] = sumsq.total_ms()
            out["zo_bounds_s"] = {"perturb_flat_kernel": peaks.zo_perturb_bound_s(d),
                                  "reconstruct_kernel": peaks.zo_reconstruct_bound_s(d, ho.m)}
        prog = {"losses": losses, "grad_norms": seen["grad_norms"], "changes": changes,
                "snaps": snaps, "evals": {t: _points(ev) for t, ev in evals.items()}}
        del params, opt_state, fo, zo, snaps, evals
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ref = reference(model, mix, ctx.seed, dev)
    out["numbers"] = numbers(prog, ref, mix)
    out["_prog"], out["_ref"] = prog, ref
    return out


def reference(model: Dict, mix: Dict, seed: int, dev, **ref_kw) -> Dict:
    """The plain reference's readings of the first steps, from the seed:
    each step's loss, the first gradient's norm and each leaf's change by
    leaf, and each ZO step's direction on the zero-initialised float32
    leaves (``reference.hosgd.follow``; ``ref_kw`` its ``control`` and
    ``rows``)."""
    from reference import hosgd

    feed = traffic.train_batches(mix, model["vocab_size"], seed)
    batches = [next(feed) for _ in range(mix["setup_steps"])]
    method = dict(tau=mix["tau"], lr=mix["lr"], mu=mix["mu"], zo_lr_scale=mix["zo_lr_scale"],
                  direction_leaves=_zero_leaves(model))
    return hosgd.follow(model, weights.make(model, seed, dev), batches, method, seed, dev,
                        **ref_kw)


def _leaf_gap(got: List[float], want: List[float], keep: List[bool]) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = float(np.median([w for w, k in zip(want, keep) if k]))
    return max(abs(g - w) / max(w, med, 1e-30) for g, w, k in zip(got, want, keep) if k)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|``; where ``want`` is 0, 0 if ``got`` is too, else 1."""
    scale = float(torch.linalg.vector_norm(want))
    miss = float(torch.linalg.vector_norm(got - want))
    return miss / scale if scale > 0 else float(miss > 0)


def numbers(prog: Dict, ref: Dict, mix: Dict) -> Dict[str, float]:
    """``loss_gap``: the worst relative gap of a loss, over each step's loss
    and both losses each ZO step evaluated; ``grad_gap`` and
    ``fo_change_gap``: the worst leaf's gap of the first gradient's norm and
    of the change after the first (first-order) step (``_leaf_gap``), over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's.  Given the program's ``evals`` and ``snaps``, on the
    zero-initialised float32 leaves, the worst ZO step's: ``zo_perturb_gap``,
    the first point's offset from the step's start and the second's from
    the first, against ``mu v / |v|`` (``_rel``); ``zo_update_gap``, the
    step's update against ``-zo_lr (d / mu) (f1 - f0) v / |v|`` of the
    program's own two losses.  A ZO step that did not evaluate exactly two
    points reads infinity in all three."""
    n_setup, tau = mix["setup_steps"], mix["tau"]
    med = float(np.median(ref["grad_norms"]))
    keep = [g >= 1e-3 * med for g in ref["grad_norms"]]
    pairs = list(zip(prog["losses"], ref["losses"]))
    zo_steps = [t for t in range(1, n_setup) if t % tau]
    evals = prog.get("evals")
    for t in zo_steps:
        got = ([f for f, _ in evals.get(t, [])] if evals is not None
               else [prog["losses"][t], prog["perturbed"][t]])
        pairs += list(zip(got, [ref["losses"][t], ref["perturbed"][t]])) if len(got) == 2 \
            else [(math.inf, 1.0)]
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in pairs),
           "grad_gap": _leaf_gap(prog["grad_norms"], ref["grad_norms"], keep),
           "fo_change_gap": _leaf_gap(prog["changes"][0], ref["changes"][0], keep)}
    if evals is None:
        return out
    zero = sorted({p for _, p in ref["directions"]})
    cat = lambda pt: torch.cat([pt[p].reshape(-1) for p in zero]).double()  # noqa: E731
    perturb = update = 0.0
    for t in zo_steps:
        if len(evals.get(t, [])) != 2:
            perturb = update = math.inf
            continue
        (f0, at0), (f1, at1) = evals[t]
        start, end = cat(prog["snaps"][t - 1]), cat(prog["snaps"][t])
        v = torch.cat([ref["directions"][(t, p)].reshape(-1) for p in zero]).double()
        v = v.to(start.device) * ref["inv_norms"][t]
        offset = ref["mu"] * v
        perturb = max(perturb, _rel(cat(at0) - start + offset, offset),
                      _rel(cat(at1) - cat(at0), offset))
        coeff = (ref["d"] / ref["mu"]) * (f1 - f0)
        update = max(update, _rel(end - start, -ref["zo_lr"] * coeff * v))
    out.update(zo_perturb_gap=perturb, zo_update_gap=update)
    return out
