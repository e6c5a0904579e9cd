"""Kernel micro-benchmarks: each hand-written kernel against its plain version.

Counterpart of ``benchmarks/kernels_bench.py``, with its rows, its byte
models and its per-engine ZO round (``engine_compare``).  Each row times one
call of a kernel's wrapper (``kernels.ops``) and gives the bytes the kernel
moves (``hbm_bytes_kernel``) beside the bytes its plain PyTorch version
moves (``hbm_bytes_plain``, the reference's ``hbm_bytes_jnp``).

On the card (``--device cuda``, the default) a wrapper launches the kernel;
each row is timed with CUDA events (median of ``reps`` calls) and its output
is held against the plain version (``kernels.ref``) on the same inputs:
``max_abs_err`` within ``tol`` (``ok``).  On the CPU a wrapper runs the
plain version itself: the rows are timed by the host clock and say so
(``timed_by``), and nothing is compared.  ``zo_round`` times one ZO step of
``core.ho_sgd.make_ho_sgd`` per engine (host clock, the card synchronised)
and carries the launches ``kernels.ops.launch_counts`` counted in it beside
the reference's launch model (``flat``'s ``zo_perturb_sumsq`` is two
launches a call: ``kernels.zo_direction.LAUNCHES_PER_CALL``).

    PYTHONPATH=src python -m repro_torch.bench.kernels_bench --smoke
    PYTHONPATH=src python -m repro_torch.bench.kernels_bench --device cpu --smoke

Output: ``--out`` (default ``artifacts/BENCH_torch_kernels.json``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn: Callable, dev: torch.device, reps: int = 3) -> float:
    """Microseconds per call: CUDA events around each call on the card
    (median), the host clock on the CPU (mean); one warm-up call first."""
    fn()
    _sync(dev)
    if dev.type == "cuda":
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize(dev)
            times.append(1e3 * s.elapsed_time(e))
        return statistics.median(times)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e6 * (time.perf_counter() - t0) / reps


def close_change(got, want, base=None, rtol: float = 1e-5):
    """(ok, max abs error, tolerance): every element within ``rtol`` of the
    largest change (``want - base``) plus one float32 ulp of the element."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    change = (want if base is None else want - base.float()).abs().max()
    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    return bool((err <= rtol * change + ulp).all()), float(err.max()), \
        f"{rtol:g}*max|change| + 1 ulp"


def close_max(got, want, rel: float = 1e-4):
    """(ok, max abs error, tolerance): within ``rel`` of the largest |want|."""
    err = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    return bool(float(err.max()) <= rel * top), float(err.max()), f"{rel:g}*max|want|"


def engine_compare(dev: torch.device, smoke: bool = False) -> Dict:
    """One ZO step of ``make_ho_sgd`` per engine on the reference's
    quadratic (two leaves, odd sizes), with its direction-bytes and launch
    models (``benchmarks/kernels_bench.engine_compare``) and the launches
    counted here."""
    from repro_torch.core.ho_sgd import HOSGDConfig, make_ho_sgd

    g = torch.Generator().manual_seed(1)
    d_leaf = (1 << 12) + 321 if smoke else (1 << 18) + 321
    m, B = 4, 8
    params = {"w": torch.randn(d_leaf, generator=g).to(dev),
              "b": torch.randn(257, generator=g).to(dev)}
    d = d_leaf + 257
    n_leaves = len(params)

    def loss_fn(p, b):
        return 0.5 * torch.mean(torch.sum((p["w"][None, :] - b["t"]) ** 2, -1)) \
            + 0.5 * torch.sum(p["b"] ** 2)

    batch = {"t": torch.randn(m * B, d_leaf, generator=g).to(dev)}
    bytes_model = {"tree": 32 * d * m, "fused": 16 * d * m, "pallas": 8 * d * m + 4 * d,
                   "flat": 8 * d * m}
    launches_model = {"tree": 0, "fused": 0, "pallas": n_leaves * (m + 1), "flat": m + 1}
    commit_passes = {"tree": 4, "fused": 4, "pallas": 4, "flat": 2}
    rows = []
    print("engine,us_per_zo_step,direction_bytes_model,kernel_launches_model,"
          "kernel_launches,hbm_passes_over_d_commit,loss")
    for name in ("tree", "fused", "pallas", "flat"):
        cfg = HOSGDConfig(tau=1 << 30, mu=1e-3, m=m, lr=0.05, zo_lr=0.05 / d, engine=name)
        meth = make_ho_sgd(loss_fn, cfg)
        state = meth.init(params)
        _, _, metrics = meth.step(1, params, state, batch)        # warm (builds the engine)
        _sync(dev)
        ops.reset_launch_counts()
        meth.step(1, params, state, batch)
        _sync(dev)
        launches = sum(ops.launch_counts().values())
        reps = 2 if smoke else 5
        t0 = time.perf_counter()
        for _ in range(reps):
            _, _, metrics = meth.step(1, params, state, batch)
        _sync(dev)
        us = 1e6 * (time.perf_counter() - t0) / reps
        loss = float(metrics["loss"])
        print(f"engine/{name},{us:.0f},{bytes_model[name]},{launches_model[name]},"
              f"{launches},{commit_passes[name]},{loss:.6f}")
        rows.append({"engine": name, "us_per_zo_step": us, "timed_by": "host clock",
                     "direction_bytes_model": bytes_model[name],
                     "kernel_launches_per_zo_round": launches_model[name],
                     "kernel_launches_counted": launches,
                     "hbm_passes_over_d_commit": commit_passes[name], "loss": loss})
    return {"d": d, "m": m, "n_leaves": n_leaves, "momentum": 0.0, "engines": rows}


def kernel_rows(dev: torch.device, smoke: bool = False) -> List[Dict]:
    """The reference's seven kernel rows and the per-leaf kernels on a run
    table, each timed and (on the card) held against its plain version."""
    g = torch.Generator().manual_seed(0)
    card = dev.type == "cuda"
    rows: List[Dict] = []

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def row(name, fn, hbm_kernel, hbm_plain, plain: Optional[Callable] = None, rule=None):
        us = timeit(fn, dev)
        rec = {"name": name, "us_per_call": us, "hbm_bytes_kernel": hbm_kernel,
               "hbm_bytes_plain": hbm_plain,
               "timed_by": "cuda events" if card else "host clock, plain version"}
        if card and plain is not None:
            ok, err, tol = rule(fn(), plain())
            rec.update(max_abs_err=err, tol=tol, ok=ok)
        rows.append(rec)
        print(f"{name},{us:.1f},{hbm_kernel},{hbm_plain}"
              + (f",err={rec['max_abs_err']:.3e},ok={rec['ok']}" if "ok" in rec else ""))

    print("name,us_per_call,hbm_bytes_kernel,hbm_bytes_plain")

    # rmsnorm: the kernel reads x and writes y; the plain version the same
    x, s = randn(2048, 1024), torch.ones(1024, device=dev)
    nb = x.numel() * 4 * 2
    row("kern/rmsnorm", lambda: ops.rmsnorm(x, s), nb, nb,
        lambda: ref.ref_rmsnorm(x, s), close_max)

    # flash attention: the kernel never stores the (S, S) probabilities
    B, S, H, hd = 1, (128 if smoke else 512), 4, 64
    q, k, v = randn(B, S, H, hd), randn(B, S, H, hd), randn(B, S, H, hd)
    io = 4 * B * S * H * hd * 4
    probs = B * H * S * S * 4
    row("kern/flash_attention", lambda: ops.flash_attention(q, k, v), io, io + 2 * probs,
        lambda: ref.ref_flash_attention(q, k, v),
        lambda a, b: close_max(a, b, 1e-5))

    # selective scan: the kernel keeps the (di, n) state on chip; the plain
    # version stores (B, S, di, n) twice and the scanned h
    B, S, di, n = 2, (64 if smoke else 256), (64 if smoke else 256), 16
    u = randn(B, S, di) * 0.3
    dt = torch.nn.functional.softplus(randn(B, S, di)) * 0.1
    Bm, Cm = randn(B, S, n), randn(B, S, n)
    A = -torch.exp(randn(di, n) * 0.2)
    Dp = torch.ones(di, device=dev)
    io = (3 * B * S * di + 2 * B * S * n) * 4
    row("kern/selective_scan", lambda: ops.selective_scan(u, dt, Bm, Cm, A, Dp),
        io, io + 3 * B * S * di * n * 4,
        lambda: ref.ref_selective_scan(u, dt, Bm, Cm, A, Dp), close_max)

    # zo perturb: one read and one write of x (the direction never stored);
    # the plain version also writes and reads the direction; an odd size
    npar = (1 << 14) + 321 if smoke else (1 << 20) + 321
    xx = randn(npar)
    row("kern/zo_perturb", lambda: ops.zo_perturb(xx, 55, 0.01, 0), npar * 4 * 2, npar * 4 * 4,
        lambda: ref.ref_zo_perturb(xx, 55, 0.01, 0),
        lambda a, b: close_change(a, b, xx))

    # zo reconstruct (m=8): one write; the plain version m reads and writes
    m = 8
    salts = torch.arange(m, dtype=torch.int64).to(torch.uint32).to(dev)
    coeffs = torch.linspace(-1, 1, m, device=dev)
    row("kern/zo_reconstruct", lambda: ops.zo_reconstruct(npar, salts, coeffs, 0),
        npar * 4, npar * 4 * 2 * m,
        lambda: ref.ref_zo_reconstruct(npar, list(range(m)), coeffs, 0, device=dev),
        close_change)

    # the same two on a shard's run table (a column-parallel leaf's rows):
    # runs of 1027 lanes (no multiple of a 16-byte vector), their counters
    # crossing 2^32 between runs
    run = 1027
    nruns = -(-npar // run)
    xr = randn(nruns * run)
    starts = ((torch.arange(nruns, dtype=torch.int64) * 2 * run + 2 ** 32 - 5 * run)
              % 2 ** 32).to(torch.uint32).to(dev)
    row("kern/zo_perturb_runs", lambda: ops.zo_perturb(xr, 55, 0.01, starts=starts),
        xr.numel() * 4 * 2 + nruns * 4, xr.numel() * 4 * 4,
        lambda: ref.ref_zo_perturb(xr, 55, 0.01, starts=starts),
        lambda a, b: close_change(a, b, xr))
    row("kern/zo_reconstruct_runs",
        lambda: ops.zo_reconstruct(xr.numel(), salts, coeffs, starts=starts),
        xr.numel() * 4 + nruns * 4, xr.numel() * 4 * 2 * m,
        lambda: ref.ref_zo_reconstruct(xr.numel(), list(range(m)), coeffs, device=dev,
                                       starts=starts),
        close_change)

    # the flat kernels on a block-aligned packed buffer
    block = 4096
    nblk = -(-npar // block)
    xflat = torch.cat([xx, torch.zeros(nblk * block - npar, device=dev)])
    bsalts = torch.full((nblk,), 55, dtype=torch.int64).to(torch.uint32).to(dev)
    ctrs = (torch.arange(nblk, dtype=torch.int64) * block).to(torch.uint32).to(dev)
    nvalid = torch.clamp(npar - torch.arange(nblk) * block, max=block).to(torch.int32).to(dev)
    row("kern/zo_perturb_sumsq",
        lambda: ops.zo_perturb_sumsq(xflat, bsalts, ctrs, nvalid, 1e-3, block)[0],
        npar * 4 * 2, npar * 4 * 3,
        lambda: ref.ref_zo_perturb_sumsq(xflat, bsalts, ctrs, nvalid, 1e-3, block)[0],
        lambda a, b: close_change(a, b, xflat))

    msalts = salts[None, :].repeat(nblk, 1).contiguous()
    bf16 = torch.zeros(nblk, dtype=torch.int32, device=dev)
    # the update is in place: each call takes a fresh copy of the buffer
    row("kern/zo_reconstruct_update",
        lambda: ops.zo_reconstruct_update(xflat.clone(), None, msalts, ctrs, nvalid, bf16,
                                          coeffs, 0.05, block=block)[0],
        npar * 4 * 2, npar * 4 * 4,
        lambda: ref.ref_zo_reconstruct_update(xflat, None, msalts, ctrs, nvalid, bf16,
                                              coeffs, 0.05, block=block)[0],
        lambda a, b: close_change(a, b, xflat))
    return rows


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="small sizes, few reps")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join("artifacts", "BENCH_torch_kernels.json"),
                    help="JSON output path ('' disables)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    payload = {"generated_by": "repro_torch.bench.kernels_bench", "smoke": args.smoke,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "kernels": kernel_rows(dev, args.smoke),
               "zo_round": engine_compare(dev, args.smoke)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        print(f"# wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
