#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases (any failed check exits non-zero):
  1. device: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: nvcc compiles the kernels from ``src/repro_torch/kernels/csrc``,
     and cuobjdump's SASS gives the instructions of one Gaussian;
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the Fig. 2 packed shape (437 blocks of 4096, m=4) and a ragged layout
     (leaves of 1, 7, 4095, 4097 and 70200 values, one bf16), over
     acc_dtype {fp32, bf16} and momentum {0, 0.9}, with controls (faulty
     outputs that must fail each check); kernel and plain times (CUDA
     events, median of 20 after warm-up) and the bound, the larger of bytes
     over the HBM rate and Gaussians x instructions over the issue rate;
  4. Fig. 2 main path: HO-SGD on covtype at hidden=1300 (d=1,771,907), m=4,
     B=64, tau=8, 32 steps, engine="flat" with plain SGD, through
     ``apps.classification.run_comparison``; held against engine="fused"
     (plain PyTorch on the card, no kernels) and, at hidden=64, against the
     CPU run;
  5. the generic flat path: the same model with Adam, where the flat engine
     runs ``zo_perturb_flat``/``zo_reconstruct_flat``;
  6. Fig. 1: the universal attack (d=900), 16 steps with engine="flat".
The last two lines are the kernels JSON and the device JSON.  Launch counts
are set to 0 just before each path and read just after it.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# The float32 rate counts an FMA as two operations: one instruction per lane
# per clock on 128 lanes per SM, which is also the issue rate of 4 warp
# instructions per SM and clock.  No instruction, integer or special
# function, issues faster, so instructions at this rate bound the kernels.
INSTR_PER_S = FP32_OPS_PER_S / 2
# a bf16 output may differ from its plain version in this share of its
# elements at most, each by one bf16 ulp (an ulp of logf/cosf can flip a
# rounding); a skipped bf16 rounding changes far more of them
MISMATCH_FRAC = 1e-3
CUDA_SRC = "src/repro_torch/kernels/csrc/zo_direction.cu"
REPLACES = {
    "zo_perturb_sumsq": "src/repro/kernels/zo_direction.py:349",
    "zo_reconstruct_update": "src/repro/kernels/zo_direction.py:447",
    "zo_perturb_flat": "src/repro/kernels/zo_direction.py:236",
    "zo_reconstruct_flat": "src/repro/kernels/zo_direction.py:275",
}
SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms: CUDA events around
    each call, with a sleep kernel queued in front so that the host has
    enqueued the whole call before the start event runs (the events then
    time the device's work, not the host's Python)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)      # ~10 ms of GPU clock cycles
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_instr: float):
    tb, ti = n_bytes / HBM_BYTES_PER_S * 1e3, n_instr / INSTR_PER_S * 1e3
    return (tb, "bytes") if tb >= ti else (ti, "operations")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# phase 2: the instruction cost of one Gaussian, from the built SASS
# --------------------------------------------------------------------------- #
def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output -> {function: [(addr, predicated, op, args)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), [])
            continue
        ins = SASS_INSTR.search(line)
        if ins and cur is not None:
            cur.append((int(ins.group(1), 16), bool(ins.group(2)), ins.group(3),
                        ins.group(4)))
    return funcs


def shortest_path(instrs, start: int = 0, ends=("EXIT",)) -> int:
    """Fewest instructions one lane can execute from ``start`` to an ``ends``
    instruction: a conditional branch may go either way, a call costs its
    callee's own shortest path to RET, NOPs cost nothing."""
    import heapq

    index = {addr: k for k, (addr, *_) in enumerate(instrs)}

    def target(args):
        return index[int(re.findall(r"0x[0-9a-f]+", args)[-1], 16)]

    dist, heap = {start: 0}, [(0, start)]
    while heap:
        d, k = heapq.heappop(heap)
        if d > dist[k]:
            continue
        _, pred, op, args = instrs[k]
        base = op.split(".")[0]
        cost = 0 if base == "NOP" else 1
        if base in ends:
            return d + cost
        if base == "CALL":
            cost += shortest_path(instrs, target(args), ("RET",))
        nxt = []
        if base == "BRA":
            nxt.append(target(args))
            if pred or "," in args:          # predicated or uniform-predicated
                nxt.append(k + 1)
        elif base in ("EXIT", "RET"):
            if pred:
                nxt.append(k + 1)
        else:
            nxt.append(k + 1)
        for j in nxt:
            if j < len(instrs) and d + cost < dist.get(j, math.inf):
                dist[j] = d + cost
                heapq.heappush(heap, (d + cost, j))
    fail("no path to the end of a probe kernel in its SASS")


def gauss_instructions(lib: Path) -> int:
    """Instructions of one IEEE Gaussian: the shortest SASS path of
    ``zo_probe_gauss`` less that of ``zo_probe_base`` (the same kernel
    without the Gaussian), read from the library that was just built."""
    from repro_torch.kernels.build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    funcs = sass_functions(out.stdout)
    check({"zo_probe_gauss", "zo_probe_base"} <= set(funcs),
          f"probe kernels missing from the SASS ({sorted(funcs)[:8]})")
    g, b = shortest_path(funcs["zo_probe_gauss"]), shortest_path(funcs["zo_probe_base"])
    print(f"# one Gaussian: {g - b} instructions on the shortest SASS path "
          f"(zo_probe_gauss {g} - zo_probe_base {b}; zo_probe_gauss holds "
          f"{len(funcs['zo_probe_gauss'])} instructions in all)")
    check(g - b > 10, "implausible instruction count for one Gaussian")
    return g - b


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def agree(torch, got, want, base=None, rtol=1e-5, bf16=False):
    """(ok, max abs error, tolerance text) of ``got`` against ``want``.

    fp32: every element within ``rtol * max|want - base|`` (the size of the
    change the kernel computes, not of the values it is added to) plus one
    f32 ulp of the element.  bf16: every element within one bf16 ulp of its
    own value, and at most MISMATCH_FRAC of them not bitwise equal."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if bf16:
        _, e = torch.frexp(want)
        ulp = torch.where(want == 0, torch.zeros_like(want),
                          torch.ldexp(torch.ones_like(want), e - 8))
        frac = float((got != want).float().mean())
        ok = bool((err <= ulp).all()) and frac <= MISMATCH_FRAC
        tol = f"1 bf16 ulp each, {frac:.2e} differ (limit {MISMATCH_FRAC:g})"
    else:
        change = (want if base is None else want - base.float()).abs().max()
        a = want.abs()
        ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
        ok = bool((err <= rtol * change + ulp).all())
        tol = f"tol {rtol:g}*max|change| = {float(rtol * change):.3e} + 1 ulp"
    return ok, float(err.max()), tol


def kernel_phase(torch, dev, fig2_params, gauss_instr):
    import numpy as np

    from repro_torch.core.engine import FlatEngine
    from repro_torch.kernels import ref
    from repro_torch.kernels import zo_direction as cu

    g = torch.Generator().manual_seed(7)
    sizes = {"a": 1, "b": 7, "c": 4095, "d": 4097, "e": 70200}
    ragged = {k: torch.randn(n, generator=g).to(dev) for k, n in sizes.items()}
    ragged["d"] = ragged["d"].to(torch.bfloat16)
    layouts = {"fig2": FlatEngine(fig2_params, seed=0),
               "ragged": FlatEngine(ragged, seed=0)}
    inputs = {"fig2": fig2_params, "ragged": ragged}
    check(int(layouts["ragged"]._blk_bf16.sum()) == 2, "ragged layout lacks its bf16 blocks")

    m, t = 4, 3
    coeffs = torch.tensor([0.5, -1.0, 2.0, 0.1], device=dev)
    lr = 0.05
    errs = {k: 0.0 for k in REPLACES}
    sumsq_rel = 0.0

    def compare(name, got, want, what, **kw):
        ok, err, tol = agree(torch, got, want, **kw)
        print(f"  {name:22s} {what:42s} max_abs_err={err:.3e} {tol}")
        check(ok, f"{name} {what}: kernel and plain version disagree ({err}, {tol})")
        errs[name] = max(errs[name], err)

    def control(name, bad, want, what, **kw):
        ok, err, _ = agree(torch, bad, want, **kw)
        print(f"  {name:22s} control, {what}: fails the check (max_abs_err={err:.3e})")
        check(not ok, f"{name}: the check lets a faulty output pass ({what})")

    for lname, eng in layouts.items():
        x = eng.pack(inputs[lname])
        s1 = eng.blk_salts(t, 1)
        sm = eng.blk_salts_multi(t, range(m))
        ctr, nv, bf = eng._blk_ctr, eng._blk_nv, eng._blk_bf16
        B = eng.block
        bfe = (bf != 0).repeat_interleave(B)          # lanes of bf16 blocks

        want = ref.ref_zo_perturb_flat(x, s1, ctr, nv, 1e-2, B)
        compare("zo_perturb_flat", cu.zo_perturb_flat(x, s1, ctr, nv, 1e-2, B), want,
                lname, base=x)
        control("zo_perturb_flat", x, want, f"{lname} x left unperturbed", base=x)

        wants = {}
        for acc in ("float32", "bfloat16"):
            wants[acc] = ref.ref_zo_reconstruct_flat(sm, coeffs, ctr, nv, B, acc)
            compare("zo_reconstruct_flat",
                    cu.zo_reconstruct_flat(sm, coeffs, ctr, nv, B, acc), wants[acc],
                    f"{lname} acc={acc}", bf16=acc == "bfloat16")
        control("zo_reconstruct_flat", wants["float32"], wants["bfloat16"],
                f"{lname} fp32 accumulator", bf16=True)
        control("zo_reconstruct_flat", wants["float32"].bfloat16().float(),
                wants["bfloat16"], f"{lname} bf16 rounding only after the last worker",
                bf16=True)

        out, ss = cu.zo_perturb_sumsq(x, s1, ctr, nv, 1e-3, B)
        want, wss = ref.ref_zo_perturb_sumsq(x, s1, ctr, nv, 1e-3, B)
        compare("zo_perturb_sumsq", out, want, f"{lname} out (mu=1e-3)", base=x)
        rel = float((ss / wss - 1.0).abs().max())
        print(f"  {'zo_perturb_sumsq':22s} {lname + ' sumsq':42s} relative error "
              f"{rel:.3e} (tol 1e-5)")
        check(rel <= 1e-5, f"zo_perturb_sumsq {lname} sumsq: relative error {rel}")
        sumsq_rel = max(sumsq_rel, rel)
        control("zo_perturb_sumsq", x, want, f"{lname} x left unperturbed", base=x)
        nb = eng.n_blocks
        salt0 = torch.from_numpy(np.full(nb, int(s1[0]), np.uint32)).to(dev)
        ctr0 = torch.from_numpy(np.full(nb, int(ctr[0]), np.uint32)).to(dev)
        control("zo_perturb_sumsq", ref.ref_zo_perturb_sumsq(x, salt0, ctr0, nv, 1e-3, B)[0],
                want, f"{lname} block 0's salt and counter in every block", base=x)
        mu1 = math.sqrt(eng.dim)                      # scale * v is O(1)
        compare("zo_perturb_sumsq", cu.zo_perturb_sumsq(x, s1, ctr, nv, mu1, B)[0],
                ref.ref_zo_perturb_sumsq(x, s1, ctr, nv, mu1, B)[0],
                f"{lname} out (mu=sqrt(d)={mu1:.1f})", base=x)
        out2, ss2 = cu.zo_perturb_sumsq(x, s1, ctr, nv, 1e-3, B)
        check(torch.equal(out, out2) and torch.equal(ss, ss2),
              "zo_perturb_sumsq is not deterministic run to run")

        for acc in ("float32", "bfloat16"):
            for momentum in (0.0, 0.9):
                mom = None if momentum == 0.0 else torch.full_like(x, 0.1)
                p_k, m_k = cu.zo_reconstruct_update(
                    x.clone(), None if mom is None else mom.clone(), sm, ctr, nv,
                    bf, coeffs, lr, momentum, B, acc)
                p_r, m_r = ref.ref_zo_reconstruct_update(
                    x, mom, sm, ctr, nv, bf, coeffs, lr, momentum, B, acc)
                what = f"{lname} acc={acc} momentum={momentum}"
                compare("zo_reconstruct_update", p_k[~bfe], p_r[~bfe], what + " p",
                        base=x[~bfe])
                if bool(bfe.any()):
                    compare("zo_reconstruct_update", p_k[bfe], p_r[bfe],
                            what + " p, bf16 blocks", bf16=True)
                if mom is not None:
                    compare("zo_reconstruct_update", m_k, m_r, what + " mom", base=mom)
                if momentum == 0.0 and acc == "bfloat16":
                    p32, _ = ref.ref_zo_reconstruct_update(
                        x, None, sm, ctr, nv, bf, coeffs, lr, 0.0, B, "float32")
                    control("zo_reconstruct_update", p32[~bfe], p_r[~bfe],
                            f"{lname} fp32 accumulator", base=x[~bfe])
                if momentum == 0.0 and bool(bfe.any()):
                    p_nb, _ = ref.ref_zo_reconstruct_update(
                        x, None, sm, ctr, nv, torch.zeros_like(bf), coeffs, lr, 0.0, B, acc)
                    control("zo_reconstruct_update", p_nb[bfe], p_r[bfe],
                            f"{lname} acc={acc} no bf16 round-trip", bf16=True)
    torch.cuda.synchronize()

    # times at the Fig. 2 shape, main-path configuration (fp32 acc, no momentum)
    eng = layouts["fig2"]
    x = eng.pack(fig2_params)
    s1, sm = eng.blk_salts(t, 1), eng.blk_salts_multi(t, range(m))
    ctr, nv, bf, B = eng._blk_ctr, eng._blk_nv, eng._blk_bf16, eng.block
    P, nb, d = eng.padded_dim, eng.n_blocks, eng.dim
    p_work = x.clone()
    meta = nb * 12                       # salts, counters, valid lanes
    # instructions: one Gaussian per valid lane and worker (the function needs
    # each once, though zo_perturb_sumsq's two launches make it twice)
    runs = {
        "zo_perturb_sumsq": (
            lambda: cu.zo_perturb_sumsq(x, s1, ctr, nv, 1e-3, B),
            lambda: ref.ref_zo_perturb_sumsq(x, s1, ctr, nv, 1e-3, B),
            2 * P * 4 + meta + 4, d * gauss_instr),
        "zo_reconstruct_update": (
            lambda: cu.zo_reconstruct_update(p_work, None, sm, ctr, nv, bf, coeffs,
                                             lr, 0.0, B, "float32"),
            lambda: ref.ref_zo_reconstruct_update(x, None, sm, ctr, nv, bf, coeffs,
                                                  lr, 0.0, B, "float32"),
            2 * P * 4 + nb * (8 + 4 * m) + 4 * m + 4, d * m * gauss_instr),
        "zo_perturb_flat": (
            lambda: cu.zo_perturb_flat(x, s1, ctr, nv, 1e-2, B),
            lambda: ref.ref_zo_perturb_flat(x, s1, ctr, nv, 1e-2, B),
            2 * P * 4 + meta + 4, d * gauss_instr),
        "zo_reconstruct_flat": (
            lambda: cu.zo_reconstruct_flat(sm, coeffs, ctr, nv, B, "float32"),
            lambda: ref.ref_zo_reconstruct_flat(sm, coeffs, ctr, nv, B, "float32"),
            P * 4 + nb * (8 + 4 * m) + 4 * m, d * m * gauss_instr),
    }
    rows = {}
    for name, (kern, plain, nbytes, ninstr) in runs.items():
        # plain, kernel, kernel, plain: each version's time is the mean of its
        # two medians, so a drift in clocks hits both alike
        p1 = cuda_ms(torch, plain)
        k1 = cuda_ms(torch, kern)
        k2 = cuda_ms(torch, kern)
        p2 = cuda_ms(torch, plain)
        b, by = bound_ms(nbytes, ninstr)
        rows[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                      "bound_ms": b, "bound_by": by, "max_abs_err": errs[name]}
        if name == "zo_perturb_sumsq":
            rows[name]["sumsq_rel_err"] = sumsq_rel
        print(f"  {name:22s} ms={rows[name]['ms']:.4f} plain_ms="
              f"{rows[name]['plain_ms']:.4f} bound_ms={b:.4f} ({by}; bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}, instructions "
              f"{ninstr / INSTR_PER_S * 1e3:.4f}) library_ms=none (no PyTorch "
              f"call computes the hashed Gaussian)")
    return rows


# --------------------------------------------------------------------------- #
# phases 4-6: the training paths
# --------------------------------------------------------------------------- #
def fig2_phase(torch, dev, hidden=1300):
    from repro_torch.apps.classification import run_comparison
    from repro_torch.kernels import ops

    kw = dict(n_iters=32, m=4, B=64, tau=8, hidden=hidden, lr=0.05, mu=1e-3,
              methods=["ho_sgd"], seed=0, eval_every=32)
    ops.reset_launch_counts()
    flat = run_comparison("covtype", engine="flat", device=dev, **kw)["ho_sgd"]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"  launches (flat, 32 steps): {launches}")
    ops.reset_launch_counts()
    fused = run_comparison("covtype", engine="fused", device=dev, **kw)["ho_sgd"]
    torch.cuda.synchronize()
    check(sum(ops.launch_counts().values()) == 0, "the fused engine launched a kernel")

    n_zo = flat["order"].count(0)
    check(flat["order"] == fused["order"], "FO/ZO order sequences differ")
    check(flat["order"] == [1 if t % 8 == 0 else 0 for t in range(32)],
          f"unexpected order sequence {flat['order']}")
    check(launches["zo_perturb_sumsq"] == 2 * 4 * n_zo,
          f"zo_perturb_sumsq launched {launches['zo_perturb_sumsq']} times, "
          f"expected 2 per worker per ZO step = {2 * 4 * n_zo}")
    check(launches["zo_reconstruct_update"] == n_zo,
          f"zo_reconstruct_update launched {launches['zo_reconstruct_update']} "
          f"times, expected {n_zo}")
    lf, lu = flat["loss"], fused["loss"]
    check(all(math.isfinite(v) for v in lf + lu), "non-finite loss")
    rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lu))
    print(f"  loss flat  {lf[0]:.6f} .. {lf[-1]:.6f}\n  loss fused {lu[0]:.6f} .. "
          f"{lu[-1]:.6f}\n  max relative loss difference {rel:.3e} (tol 1e-3)")
    check(rel <= 1e-3, f"flat vs fused loss trajectories differ by {rel}")
    for name, h in (("flat", flat), ("fused", fused)):
        fo = [s for s, o in zip(h["iter_s"][1:], h["order"][1:]) if o == 1]
        zo = [s for s, o in zip(h["iter_s"], h["order"]) if o == 0]
        print(f"  step time {name:5s}: FO median {1e3 * statistics.median(fo):.3f} ms "
              f"(n={len(fo)}, first step excluded), ZO median "
              f"{1e3 * statistics.median(zo):.3f} ms (n={len(zo)}); "
              f"final_acc={h['final_acc']:.4f}")
    for p in flat["params"].values():
        check(bool(torch.isfinite(p).all()), "non-finite parameters after training")
    check(flat["params"]["w2"].shape == (hidden, hidden), "unexpected parameter shape")

    # small input: the card's flat run against the CPU plain run
    small = dict(kw, hidden=64, n_iters=8, eval_every=8)
    gpu = run_comparison("covtype", engine="flat", device=dev, **small)["ho_sgd"]
    cpu = run_comparison("covtype", engine="flat", device="cpu", **small)["ho_sgd"]
    rel_small = max(abs(a - b) / abs(b) for a, b in zip(gpu["loss"], cpu["loss"]))
    print(f"  hidden=64: card vs CPU max relative loss difference {rel_small:.3e} (tol 1e-3)")
    check(rel_small <= 1e-3 and gpu["order"] == cpu["order"], "card and CPU runs differ")
    return launches


def profile_phase(torch, dev, hidden=1300):
    """Where a main-path ZO step's time goes: torch.profiler over 7 ZO steps
    (t=9..15) after 7 warm-up ZO steps; device busy time by kernel and the
    device's idle share of the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps.classification import load_dataset
    from repro_torch.core import HOSGDConfig, make_ho_sgd
    from repro_torch.data.synthetic import batches
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss

    ds = load_dataset("covtype")
    params = init_mlp_classifier(torch.Generator().manual_seed(0), ds.n_features,
                                 ds.n_classes, hidden=hidden, device=dev)
    d = sum(p.numel() for p in params.values())
    meth = make_ho_sgd(mlp_loss, HOSGDConfig(tau=8, mu=1e-3, m=4, lr=0.05,
                                             zo_lr=0.05 * 30.0 / d, engine="flat"))
    state, data = meth.init(params), batches(ds, 256, seed=1)
    for t in range(1, 8):
        params, state, _ = meth.step(t, params, state, next(data))
    steps = [next(data) for _ in range(9, 16)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t, b in zip(range(9, 16), steps):
            params, state, _ = meth.step(t, params, state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): an operator's CPU event
    # carries its kernels' time as well and would count it twice
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    n = len(steps)
    print(f"  {n} ZO steps: host wall {1e3 * wall / n:.3f} ms/step")
    if not rows:
        print("  device busy time and idle share: not measured (the profiler saw "
              "no device time)")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"  device busy {busy_ms / n:.3f} ms/step, device idle share "
          f"{1.0 - busy_ms / (1e3 * wall):.3f}")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"    {us / 1e3 / n:8.4f} ms/step  {count // n:4d} calls/step  {key[:90]}")


def generic_flat_phase(torch, dev, hidden=1300):
    """The flat engine's standard primitives: HO-SGD with Adam at full width."""
    from repro_torch.apps.classification import load_dataset
    from repro_torch.core import HOSGDConfig, make_ho_sgd, run_method
    from repro_torch.data.synthetic import batches
    from repro_torch.kernels import ops
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss
    from repro_torch.opt.optimizers import adam, const_schedule

    ds = load_dataset("covtype")
    p0 = init_mlp_classifier(torch.Generator().manual_seed(0), ds.n_features,
                             ds.n_classes, hidden=hidden, device=dev)
    hists = {}
    for engine in ("flat", "fused"):
        cfg = HOSGDConfig(tau=8, mu=1e-3, m=4, lr=1e-3, engine=engine)
        meth = make_ho_sgd(mlp_loss, cfg, opt=adam(const_schedule(1e-3)))
        ops.reset_launch_counts()
        hists[engine] = run_method(meth, p0, batches(ds, 256, seed=1), 8)
        torch.cuda.synchronize()
        hists[engine]["launches"] = ops.launch_counts()
    launches = hists["flat"]["launches"]
    print(f"  launches (flat + adam, 8 steps): {launches}")
    n_zo = hists["flat"]["order"].count(0)
    check(launches["zo_perturb_flat"] == 4 * n_zo, "zo_perturb_flat launches")
    check(launches["zo_reconstruct_flat"] == n_zo, "zo_reconstruct_flat launches")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(hists["flat"]["loss"], hists["fused"]["loss"]))
    print(f"  adam: flat vs fused max relative loss difference {rel:.3e} (tol 1e-3)")
    check(rel <= 1e-3, "flat+adam vs fused+adam losses differ")
    return launches


def fig1_phase(torch, dev):
    import numpy as np

    from repro_torch.apps.attack import attack_metrics, make_attack_loss, train_victim
    from repro_torch.core import HOSGDConfig, make_ho_sgd, run_method
    from repro_torch.data.synthetic import make_digits
    from repro_torch.kernels import ops
    from repro_torch.models.mlp import mlp_logits

    victim, acc = train_victim(torch.Generator().manual_seed(0), device=dev)
    print(f"  victim accuracy {acc:.4f}")
    check(acc > 0.5, "victim failed to train")
    loss_fn, z_of = make_attack_loss(victim, c=5.0)
    x, y = make_digits(n=4096, seed=1)
    with torch.no_grad():
        preds = torch.argmax(mlp_logits(victim, torch.from_numpy(x).to(dev)), -1).cpu().numpy()
    x, y = x[preds == y], y[preds == y]
    cls = int(np.bincount(y).argmax())
    pool_x, pool_y = x[y == cls][:40], y[y == cls][:40]

    def data():
        rng = np.random.default_rng(1)
        while True:
            idx = rng.integers(0, len(pool_x), size=25)
            yield {"a": pool_x[idx], "y": pool_y[idx]}

    d, n_iters = 900, 16
    mu = 1.0 / np.sqrt(d * n_iters)
    p0 = {"x": torch.zeros(d, device=dev)}
    hists = {}
    for engine in ("flat", "fused"):
        cfg = HOSGDConfig(tau=8, mu=mu, m=5, lr=30.0 / d, engine=engine)
        ops.reset_launch_counts()
        hists[engine] = run_method(make_ho_sgd(loss_fn, cfg), p0, data(), n_iters)
        torch.cuda.synchronize()
        hists[engine]["launches"] = ops.launch_counts()
    print(f"  launches (attack, flat, {n_iters} steps): {hists['flat']['launches']}")
    check(hists["flat"]["launches"]["zo_reconstruct_update"] > 0, "attack ran no kernel")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(hists["flat"]["loss"], hists["fused"]["loss"]))
    am = attack_metrics(victim, z_of, hists["flat"]["params"], pool_x[:10], pool_y[:10])
    print(f"  attack loss {hists['flat']['loss'][0]:.5f} -> {hists['flat']['loss'][-1]:.5f}; "
          f"flat vs fused max relative difference {rel:.3e} (tol 1e-3); metrics {am}")
    check(rel <= 1e-3, "attack: flat vs fused losses differ")
    check(math.isfinite(am["l2_all"]), "attack metrics not finite")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")
    try:
        from repro_torch.device import resolve_device
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is missing next to chip_smoke.py ({e})")

    t_all = time.perf_counter()
    smi = smi_line()
    print(f"# nvidia-smi: {smi}")
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")

    t0 = time.perf_counter()
    lib = build.build("zo_direction", verbose=True)
    print(f"# build: {time.perf_counter() - t0:.1f} s")
    gauss_instr = gauss_instructions(lib)

    from repro_torch.core.engine import FlatEngine
    from repro_torch.models.mlp import init_mlp_classifier

    fig2_params = init_mlp_classifier(torch.Generator().manual_seed(0), 54, 7,
                                      hidden=1300, device=dev)
    check(sum(p.numel() for p in fig2_params.values()) == 1_771_907, "d != 1,771,907")
    fig2_layout = FlatEngine(fig2_params, seed=0)
    check(fig2_layout.n_blocks == 437 and fig2_layout.padded_dim == 1_789_952,
          "the Fig. 2 packed buffer is not 437 blocks, P=1,789,952")

    print("# phase: kernels vs plain versions on the card")
    rows = kernel_phase(torch, dev, fig2_params, gauss_instr)
    print("# phase: Fig. 2 main path (engine=flat, SGD) vs engine=fused")
    main_launches = fig2_phase(torch, dev)
    print("# phase: profile of the main path's ZO step")
    profile_phase(torch, dev)
    print("# phase: generic flat path (engine=flat, Adam)")
    generic_launches = generic_flat_phase(torch, dev)
    print("# phase: Fig. 1 universal attack (engine=flat)")
    fig1_phase(torch, dev)

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    check(not leaked, f"JAX or the JAX package was imported: {leaked[:5]}")

    kernels = []
    for name, row in rows.items():
        main = name in ("zo_perturb_sumsq", "zo_reconstruct_update")
        launches = (main_launches if main else generic_launches)[name]
        check(launches > 0, f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": CUDA_SRC,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "path": "fig2 flat+sgd" if main else "fig2 flat+adam",
            **({"sumsq_rel_err": row["sumsq_rel_err"]} if "sumsq_rel_err" in row else {}),
        })
    print(f"# total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
