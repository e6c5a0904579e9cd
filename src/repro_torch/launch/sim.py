"""Simulated-cluster training CLI: loss vs simulated seconds.

Counterpart of ``repro.launch.sim``, with its flags, printed lines, CSV
columns and JSON.  Replays the port's real step functions through
``repro_torch.sim``'s discrete-event cluster model.  Example — HO-SGD vs
sync-SGD on a bandwidth-starved link with 10% stragglers, on the card:

    PYTHONPATH=src python -m repro_torch.launch.sim --dataset acoustic \
        --methods ho_sgd sync_sgd --iters 400 --tau 8 \
        --bandwidth 1e5 --straggler-prob 0.1 --target-loss 0.9

Federated partial participation — 1024 clients, cohorts of 10 per round
with 90% availability, HO-SGD vs the FedAvg-family baselines, on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu \
        --federated 1024:10 --availability 0.9 \
        --methods fed_ho_sgd fed_avg fed_dropout_avg --batch 80 --iters 200 --tau 4

The steps are the port's own, on ``--device`` (default ``cuda``, which raises
without a GPU): the HO family's ZO rounds run the default ``fused`` engine,
plain PyTorch; the simulator's seconds (``t_sim``, ``sim_seconds``) are the
FLOP and alpha–beta models' at ``--flops`` and ``--bandwidth``, not device
times.  What differs from the reference: ``--device``; the parameters come
from the port's ``init_mlp_classifier`` with a CPU ``torch.Generator`` seeded
from ``--seed`` (the same draws on either device); the test set is moved to
the device once; the HO family's 1x1 mesh lives under a world-size-1 gloo
group (``launch.mesh.process_group``) when the caller has none.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core.ho_sgd import parse_tau_schedule
from repro_torch.data.synthetic import batches, make_classification
from repro_torch.device import host_to_device, resolve_device
from repro_torch.dist import get_compressor
from repro_torch.metrics import CSVLogger
from repro_torch.models.mlp import init_mlp_classifier, mlp_loss
from repro_torch.sim import (
    COLLECTIVE_KINDS,
    ClusterSpec,
    Topology,
    compute_model_for,
    make_sim_methods,
    simulate,
)

METHODS = ["ho_sgd", "ho_sgd_adaptive", "sync_sgd", "zo_sgd", "pa_sgd",
           "pa_gossip", "ri_sgd", "qsgd", "fed_ho_sgd", "fed_avg",
           "fed_dropout_avg"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="acoustic",
                    choices=["sensorless", "acoustic", "covtype", "seismic"])
    ap.add_argument("--hidden", type=int, default=32,
                    help="MLP hidden width (controls d)")
    ap.add_argument("--methods", nargs="*", default=["ho_sgd", "sync_sgd"],
                    choices=METHODS)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64, help="global batch (m*B)")
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--tau-schedule", default=None,
                    help="'const:K' | 'linear:start,end,horizon' for "
                         "ho_sgd_adaptive (default: linear ramp to --tau)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--zo-lr", type=float, default=None)
    ap.add_argument("--mu", type=float, default=1e-3)
    ap.add_argument("--compress", default="none",
                    choices=["none", "qsgd", "signsgd", "topk"])
    ap.add_argument("--compress-mode", default="per_worker",
                    choices=["per_worker", "legacy"],
                    help="per_worker: faithful per-worker encode + server "
                         "decode (wire bytes = nbytes x live workers); "
                         "legacy: post-reduction decode(encode(mean))")
    ap.add_argument("--replay", default="per_worker",
                    choices=["per_worker", "monolithic"],
                    help="per_worker replays rounds at the live membership "
                         "and each worker's actual params view; monolithic "
                         "keeps the pricing-only replay")
    ap.add_argument("--seed", type=int, default=0)
    # federated partial participation
    ap.add_argument("--federated", default=None, metavar="N:K",
                    help="client-sampling rounds: N total clients, seeded "
                         "cohorts of K per round (sets n_clients/cohort_k "
                         "and overrides --m with K); use with the fed_* "
                         "methods")
    ap.add_argument("--availability", type=float, default=1.0,
                    help="per-round probability a sampled client shows up "
                         "(federated churn; at least one survivor)")
    ap.add_argument("--local-steps", type=int, default=None,
                    help="fed_avg/fed_dropout_avg local SGD steps per round "
                         "(default: --tau)")
    ap.add_argument("--fed-dropout", type=float, default=0.25,
                    help="fed_dropout_avg: fraction of each client upload "
                         "zeroed (masked out) per round")
    # cluster
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--flops", type=float, default=1e9,
                    help="per-worker FLOP/s")
    ap.add_argument("--bandwidth", type=float, default=1e6, help="bytes/s")
    ap.add_argument("--alpha", type=float, default=1e-5,
                    help="per-collective latency (s)")
    ap.add_argument("--collective", default="flat",
                    choices=list(COLLECTIVE_KINDS),
                    help="all-reduce algorithm (alpha-beta round structure)")
    ap.add_argument("--pods", type=int, default=1,
                    help=">1 prices a hierarchical reduce: intra-pod "
                         "--collective + inter-pod ring on the slow link")
    ap.add_argument("--inter-alpha", type=float, default=1e-3,
                    help="inter-pod latency per collective (s)")
    ap.add_argument("--inter-bandwidth", type=float, default=1e8,
                    help="inter-pod bytes/s")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help=">0 runs ZO rounds unbarriered, each worker at "
                         "most this many rounds ahead (FO syncs barrier)")
    ap.add_argument("--elastic", action="store_true",
                    help="failures shrink the membership (no rollback); "
                         "workers rejoin via a checkpoint round-trip")
    ap.add_argument("--downtime", type=float, default=60.0,
                    help="mean elastic rejoin delay (s, exponential)")
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--straggler-slowdown", type=float, default=4.0)
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="lognormal sigma on per-iteration compute time")
    ap.add_argument("--fail-rate", type=float, default=0.0,
                    help="failures per simulated second")
    ap.add_argument("--restart-time", type=float, default=30.0)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="sim-checkpoint period (iterations); required >0 "
                         "when --fail-rate > 0")
    # overlap / contention (latency-honest rounds)
    ap.add_argument("--overlap-buckets", type=int, default=1,
                    help="bucket the HO-family collectives for compute/comm "
                         "overlap: only the exposed tail of the collective "
                         "is priced (costs.exposed_comm_time); 1 = strict "
                         "compute-then-communicate.  Bytes never change.")
    ap.add_argument("--no-contention", action="store_true",
                    help="price concurrent async exchanges independently "
                         "instead of serializing them on shared per-pod/"
                         "inter-pod links (events.LinkContention)")
    # output
    ap.add_argument("--target-loss", type=float, default=None)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--log", default=None, help="CSV path")
    ap.add_argument("--json", default=None, help="summary JSON path")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto trace of each method's simulated "
                         "run (one lane per worker; multi-method runs get "
                         "OUT.METHOD.json) and print its attribution")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_clients = cohort_k = 0
    if args.federated:
        n_str, _, k_str = args.federated.partition(":")
        n_clients, cohort_k = int(n_str), int(k_str)
        assert cohort_k >= 1, "--federated N:K needs K >= 1"
        args.m = cohort_k    # the sim's worker slots hold the cohort

    topo = (Topology(pods=args.pods, inter_alpha=args.inter_alpha,
                     inter_bandwidth=args.inter_bandwidth)
            if args.pods > 1 else None)
    cluster = ClusterSpec(
        m=args.m, flops_per_sec=args.flops, alpha=args.alpha,
        bandwidth=args.bandwidth, collective=args.collective, topology=topo,
        max_staleness=args.max_staleness, straggler_prob=args.straggler_prob,
        straggler_slowdown=args.straggler_slowdown, jitter_sigma=args.jitter,
        fail_rate=args.fail_rate, elastic=args.elastic,
        downtime=args.downtime, restart_time=args.restart_time,
        ckpt_every=args.ckpt_every, contention=not args.no_contention,
        n_clients=n_clients, cohort_k=cohort_k,
        availability=args.availability, seed=args.seed)

    ds = make_classification(args.dataset, seed=args.seed)
    params = init_mlp_classifier(torch.Generator().manual_seed(args.seed),
                                 ds.n_features, ds.n_classes,
                                 hidden=args.hidden, device=dev)
    d = sum(int(x.numel()) for x in params.values())
    assert args.batch % cluster.m == 0, "--batch must divide by --m"
    compute = compute_model_for(params, cluster, args.batch // cluster.m)
    eval_batch = {"x": host_to_device(ds.x_test, dev),
                  "y": host_to_device(ds.y_test, dev)}

    @torch.no_grad()
    def eval_fn(p):
        return mlp_loss(p, eval_batch)

    sched = (parse_tau_schedule(args.tau_schedule)
             if args.tau_schedule else None)
    sims = make_sim_methods(
        mlp_loss, params, cluster, tau=args.tau, lr=args.lr, zo_lr=args.zo_lr,
        mu=args.mu, seed=args.seed, codec=get_compressor(args.compress),
        compress_mode=args.compress_mode, tau_schedule=sched,
        which=args.methods, overlap_buckets=args.overlap_buckets,
        local_steps=args.local_steps, fed_dropout=args.fed_dropout)

    print(f"sim: dataset={args.dataset} d={d:,} m={cluster.m} "
          f"bandwidth={cluster.bandwidth:.3g}B/s alpha={cluster.alpha:.3g}s "
          f"flops={cluster.flops_per_sec:.3g}/s seed={cluster.seed} "
          f"collective={cluster.collective} pods={args.pods} "
          f"staleness={cluster.max_staleness} elastic={cluster.elastic} "
          f"replay={args.replay} compress_mode={args.compress_mode} "
          f"overlap_buckets={args.overlap_buckets} "
          f"contention={cluster.contention}"
          + (f" federated={cluster.n_clients}:{cluster.cohort_k} "
             f"availability={cluster.availability}"
             if cluster.n_clients else ""))
    summaries = {}
    with CSVLogger(args.log, ["method", "iter", "order", "loss", "t_sim",
                              "comm_bytes"]) as logger:
        for name, sm in sims.items():
            res = simulate(
                sm, params, batches(ds, args.batch, seed=args.seed), cluster,
                args.iters, compute=compute, eval_fn=eval_fn,
                eval_every=args.eval_every, target_loss=args.target_loss,
                replay=args.replay)
            for i in range(len(res.steps)):
                logger.log(method=name, iter=res.steps[i],
                           order=res.orders[i], loss=res.losses[i],
                           t_sim=res.times[i], comm_bytes=res.comm_bytes[i])
            if args.trace:
                from repro_torch.obs import (attribution, format_report,
                                             write_trace)
                path = args.trace if len(sims) == 1 else \
                    args.trace.replace(".json", f".{name}.json")
                write_trace(path, res.spans, title=f"sim:{name}")
                for line in format_report(attribution(res.spans),
                                          title=f"trace/{name}"):
                    print(line)
                print("wrote", path)
            s = res.summary()
            if args.target_loss is not None:
                s["t_to_target"] = res.time_to_loss(args.target_loss)
                s["feval_s_to_target"] = res.feval_seconds_to_loss(
                    args.target_loss)
            summaries[name] = s
            parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in s.items() if k != "name"]
            print(f"sim/{name}: " + " ".join(parts))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"cluster": vars(args), "results": summaries}, f,
                      indent=1)
        print("wrote", args.json)
    return summaries


if __name__ == "__main__":
    main()
