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
  6. Fig. 1: the universal attack (d=900), 16 steps with engine="flat";
  7. flash attention: the CUDA kernel against its plain version at the
     serving shapes (B=1, H=40, KV=8, hd=128, bf16, causal, S in {64, 512,
     1024, 2048}) and the feature shapes (gemma2's hd=256 with window 4096
     and softcap 50, phi3's hd=96, causal off, float32), with controls (the
     KV head h % KV, the causal mask dropped); kernel, plain and
     ``scaled_dot_product_attention`` times and the bound;
  8. serving qwen3-14b at full width and depth (random bf16 weights from a
     seeded generator on the card): 8 seeded prompts of 65-1000 tokens
     through ``Engine.generate`` at temperature 0, 8 slots, 32 new tokens,
     once through the kernel (use_pallas) and once through the plain path,
     with launch counts, logits and greedy tokens held against each other,
     prefill and decode times, and profiles of one prefill and one decode
     step.
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
from concurrent.futures import ThreadPoolExecutor
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
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
CUDA_SRC = "src/repro_torch/kernels/csrc/zo_direction.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:111"
SERVE_SHAPES = (64, 512, 1024, 2048)     # prefill lengths timed at the serving shape
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


# --------------------------------------------------------------------------- #
# phase 7: flash attention against its plain version
# --------------------------------------------------------------------------- #
def attn_agree(torch, got, want):
    """(ok, max abs error, tolerance text) of an attention output.

    bf16: every element within one bf16 ulp of the plain value, where values
    under 1e-3 of the largest count as 1e-3 of it (both compute in float32
    in other summation orders and round once; an output that cancels to
    ~1e-7 keeps only float32's absolute accuracy).  float32: within 1e-5 of
    the largest value plus 1e-5 of the element."""
    got32, want32 = got.float(), want.float()
    err = (got32 - want32).abs()
    top = want32.abs().max()
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(want32.abs(), 1e-3 * top))
        tol = torch.ldexp(torch.ones_like(want32), e - 8)
        text = "1 bf16 ulp each (floor 1e-3 of max)"
    else:
        tol = 1e-5 * top + 1e-5 * want32.abs()
        text = "1e-5*max + 1e-5*|x|"
    return bool((err <= tol).all()), float(err.max()), text


def live_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks keep: the work these inputs need."""
    n = 0
    for i in range(Sq):
        lo = 0 if window is None else max(0, i - window + 1)     # i - j < window
        hi = min(Sk - 1, i) if causal else Sk - 1                # i - j >= 0
        n += max(0, hi - lo + 1)
    return n


def flash_bound(B, Sq, Sk, H, KV, hd, dtype_bytes, causal, window):
    """(bound ms, by): bytes of q, k, v read once and out written once over
    the HBM rate; the products' operations (2 * hd for q.k and 2 * hd for
    p.v per live pair and head) over the dense rate of the inputs' type."""
    n_bytes = (2 * B * Sq * H + 2 * B * Sk * KV) * hd * dtype_bytes
    ops_ = 4 * hd * H * B * live_pairs(Sq, Sk, causal, window)
    rate = BF16_OPS_PER_S if dtype_bytes == 2 else FP32_OPS_PER_S
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, ops_ / rate * 1e3
    return ((tb, "bytes") if tb >= to else (to, "operations")), n_bytes, ops_


def flash_phase(torch, dev, serve_shapes=SERVE_SHAPES, H=40, KV=8, hd=128):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(11)

    def qkv(S, H_, KV_, hd_, dtype, B=1):
        return [torch.randn(B, S, n, hd_, generator=g).to(dev, dtype) for n in (H_, KV_, KV_)]

    worst = 0.0

    def compare(what, args, causal=True, window=None, softcap=None):
        nonlocal worst
        got = fa.flash_attention(*args, causal, window, softcap)
        want = ref.ref_flash_attention(*args, causal, window, softcap)
        ok, err, tol = attn_agree(torch, got, want)
        print(f"  flash_attention {what:52s} max_abs_err={err:.3e} ({tol})")
        check(ok, f"flash_attention {what}: kernel and plain version disagree ({err})")
        worst = max(worst, err)
        return want

    def control(what, bad, want):
        ok, err, _ = attn_agree(torch, bad, want)
        print(f"  flash_attention control, {what}: fails the check (max_abs_err={err:.3e})")
        check(not ok, f"flash_attention: the check lets a faulty output pass ({what})")

    bf = torch.bfloat16
    inputs = {}
    for S in serve_shapes:
        inputs[S] = qkv(S, H, KV, hd, bf)
        want = compare(f"serving S={S} H={H} KV={KV} hd={hd} bf16 causal", inputs[S])
        if S == serve_shapes[1]:
            q, k, v = inputs[S]
            idx = torch.arange(H, device=dev) % KV
            control("KV head h % KV", ref.ref_flash_attention(q, k[:, :, idx], v[:, :, idx]), want)
            control("causal mask dropped", ref.ref_flash_attention(q, k, v, causal=False), want)
    compare("gemma2 S=4608 H=8 KV=4 hd=256 bf16 window=4096 softcap=50",
            qkv(4608, 8, 4, 256, bf), window=4096, softcap=50.0)
    compare("phi3 S=512 H=32 KV=32 hd=96 bf16", qkv(512, 32, 32, 96, bf))
    compare("S=512 H=8 KV=2 hd=128 bf16 causal off", qkv(512, 8, 2, 128, bf), causal=False)
    compare("S=512 H=8 KV=2 hd=64 float32", qkv(512, 8, 2, 64, torch.float32))
    compare("S=256 H=8 KV=2 hd=128 float32 window=100 softcap=30 B=2",
            qkv(256, 8, 2, 128, torch.float32, B=2), window=100, softcap=30.0)
    torch.cuda.synchronize()

    from torch.nn.functional import scaled_dot_product_attention as sdpa

    rows = []
    for S in serve_shapes:
        q, k, v = inputs[S]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kern = lambda: fa.flash_attention(q, k, v)                      # noqa: E731
        plain = lambda: ref.ref_flash_attention(q, k, v)                # noqa: E731
        lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
        lib_err = float((lib().transpose(1, 2).float() - plain().float()).abs().max())
        p1, k1, l1 = cuda_ms(torch, plain), cuda_ms(torch, kern), cuda_ms(torch, lib)
        l2, k2, p2 = cuda_ms(torch, lib), cuda_ms(torch, kern), cuda_ms(torch, plain)
        (b, by), n_bytes, n_ops = flash_bound(1, S, S, H, KV, hd, 2, True, None)
        row = {"S": S, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "library_ms": (l1 + l2) / 2, "bound_ms": b, "bound_by": by,
               "bytes": n_bytes, "operations": n_ops}
        rows.append(row)
        print(f"  flash_attention S={S:5d}: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} (scaled_dot_product_attention, "
              f"max |diff| to plain {lib_err:.3e}) bound_ms={b:.5f} ({by}; bytes "
              f"{n_bytes / HBM_BYTES_PER_S * 1e3:.5f}, operations {n_ops:.3e} at 989 T/s "
              f"{n_ops / BF16_OPS_PER_S * 1e3:.5f}); kernel at "
              f"{n_ops / row['ms'] / 1e9:.1f} TFLOP/s")
    return {"max_abs_err": worst, "rows": rows}


# --------------------------------------------------------------------------- #
# phase 8: serving qwen3-14b through the port
# --------------------------------------------------------------------------- #
def instrument(torch, sch, rec):
    """Time every prefill and decode of the scheduler ``sch`` (synchronised
    before and after) and keep each prefill's logits and each decode step's
    top-2 logit margin per request, in ``rec``."""
    prefill, decode = sch._prefill, sch._decode

    def top2(logits):
        v = logits.float().topk(2, dim=-1).values
        return (v[:, 0] - v[:, 1]).tolist()

    def timed_prefill(bucket):
        fn = prefill(bucket)

        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = fn(*args)
            torch.cuda.synchronize()
            rec["prefill"].append((bucket, 1e3 * (time.perf_counter() - t0),
                                   logits[0].float().cpu(), top2(logits)[0]))
            return logits, caches
        return run

    def timed_decode(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = decode(*args)
        torch.cuda.synchronize()
        rec["decode_ms"].append(1e3 * (time.perf_counter() - t0))
        for slot, mg in enumerate(top2(logits)):
            rid = int(sch.pool.owner[slot])
            if rid >= 0:
                rec["margins"].setdefault(rid, []).append(mg)
        return logits, caches

    sch._prefill, sch._decode = timed_prefill, timed_decode


def serve_phase(torch, dev, cfg=None, lens=None, max_new=32, slots=8):
    """qwen3-14b (full width and depth unless ``cfg`` is given) served twice
    on the same weights: through the flash kernel and through the plain
    path.  Returns the kernel run's launch counts and timings."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.tree import tree_leaves

    cfg = cfg or get_config("qwen3-14b")
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params:,} parameters "
          f"({n_params * 2 / 1e9:.1f} GB), initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s; KV cache "
          f"{2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2:,} B per token and slot")
    check(n_params == cfg.param_count(), f"{n_params} parameters, param_count() says "
          f"{cfg.param_count()}")

    rng = np.random.default_rng(0)
    lens = lens or [65, 1000] + [int(n) for n in rng.integers(65, 1001, 6)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in lens]
    max_seq = (1 << (max(lens) - 1).bit_length()) + max_new   # the largest bucket fits
    print(f"  {len(prompts)} prompts of {lens} tokens, {max_new} new tokens each, "
          f"{slots} slots, max_seq {max_seq}")

    runs = {}
    for use_pallas in (True, False):
        eng = Engine(cfg.with_(use_pallas=use_pallas), params,
                     ServeConfig(max_seq=max_seq, slots=slots))
        rec = {"prefill": [], "decode_ms": [], "margins": {}}
        instrument(torch, eng.scheduler, rec)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs = eng.generate(prompts, max_new)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = ops.launch_counts()
        rec["outs"] = outs
        rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
        runs[use_pallas] = rec
        del eng

    fast, plain = runs[True], runs[False]
    n_prefill = len(fast["prefill"])
    check(n_prefill == len(prompts), f"{n_prefill} prefills for {len(prompts)} prompts")
    kernel_buckets = [b for b, *_ in fast["prefill"] if b % 64 == 0]
    want_launches = len(kernel_buckets) * cfg.n_layers
    print(f"  launches: kernel run {fast['launches']['flash_attention']} "
          f"(prefills on 64-aligned buckets {len(kernel_buckets)} x {cfg.n_layers} layers "
          f"= {want_launches}), plain run {plain['launches']['flash_attention']}")
    check(fast["launches"]["flash_attention"] == want_launches == n_prefill * cfg.n_layers,
          "flash_attention launches != admitted prefills x layers")
    check(plain["launches"]["flash_attention"] == 0, "the plain run launched the kernel")

    # last-prompt-token logits of the two runs
    top = max(float(lg.abs().max()) for _, _, lg, _ in plain["prefill"])
    tol = 0.05 * top
    diffs = [float((a[2] - b[2]).abs().max()) for a, b in zip(fast["prefill"], plain["prefill"])]
    print(f"  last-prompt-token logits, kernel vs plain run: max |diff| {max(diffs):.4f} "
          f"(per prompt {[round(d, 4) for d in diffs]}); tolerance 5% of the largest "
          f"logit {top:.3f} = {tol:.4f} (both paths round each attention output to bf16 "
          f"from float32 sums in other orders; a flipped rounding is 2**-8 of a value and "
          f"spreads through every later bf16 operation of {cfg.n_layers} layers: two "
          f"layers already differ by ~0.7%)")
    check(all(math.isfinite(d) for d in diffs) and max(diffs) <= tol,
          "kernel and plain runs' prefill logits disagree")
    # greedy tokens; where they part, the plain run's top-2 margin there must be a near-tie
    n_diff = 0
    for rid, (a, b) in enumerate(zip(fast["outs"], plain["outs"])):
        check(len(a) == len(b) == lens[rid] + max_new, "wrong output length")
        gen_a, gen_b = a[lens[rid]:], b[lens[rid]:]
        if gen_a != gen_b:
            n_diff += 1
            t = next(i for i, (x, y) in enumerate(zip(gen_a, gen_b)) if x != y)
            margins = [plain["prefill"][rid][3]] + plain["margins"][rid]
            print(f"  request {rid}: tokens part at generated token {t} ({gen_a[t]} vs "
                  f"{gen_b[t]}); the plain run's top-2 margin there is {margins[t]:.4f}")
            check(margins[t] <= tol, f"request {rid}: tokens differ where the plain run's "
                  f"top-2 margin {margins[t]:.4f} exceeds {tol:.4f}")
    print(f"  greedy tokens: {len(prompts) - n_diff} of {len(prompts)} requests identical "
          f"over all {max_new} tokens")
    for rid, o in enumerate(fast["outs"]):
        check(all(0 <= t < cfg.vocab_size for t in o), "token out of range")

    print(f"  times on {smi_line()} (host clock, synchronised around each call):")
    for name, rec in (("kernel", fast), ("plain", plain)):
        by_bucket = {}
        for b, ms, *_ in rec["prefill"]:
            by_bucket.setdefault(b, []).append(ms)
        n_tok = len(prompts) * max_new
        dec = rec["decode_ms"]
        print(f"  {name:6s} run: prefill ms by bucket "
              f"{ {b: [round(x, 3) for x in v] for b, v in sorted(by_bucket.items())} }; "
              f"decode {len(dec)} steps, median {statistics.median(dec):.3f} ms/step "
              f"(first {dec[0]:.3f}); {n_tok} tokens in {rec['wall_s']:.3f} s = "
              f"{n_tok / rec['wall_s']:.1f} tok/s; peak memory {rec['peak_gb']:.1f} GB")
    return {"launches": fast["launches"], "params": params, "prompts": prompts,
            "cfg": cfg}


def profile_call(torch, what, fn):
    """torch.profiler over one call of ``fn`` (after one warm-up call): host
    wall, device busy and idle share, device kernels launched, and device
    time by kernel, with the flash kernel's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print(f"  {what}: not measured (the profiler saw no device time)")
        return
    busy = sum(r[0] for r in rows) / 1e3
    flash = sum(r[0] for r in rows if "flash_fwd" in r[2]) / 1e3
    print(f"  {what} under the profiler: host wall {1e3 * wall:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {1 - busy / (1e3 * wall):.3f}), "
          f"{sum(r[1] for r in rows)} device kernels and copies; flash kernel "
          f"{flash:.3f} ms = {flash / busy:.3f} of device time")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {us / 1e3:9.3f} ms  {count:5d} calls  {key[:90]}")


def serve_profiles(torch, cfg, params, tokens, slots=8, max_seq=1056):
    """One kernel-path prefill of ``tokens`` (right-padded to its
    power-of-two bucket, as the scheduler pads it) and one decode step over
    a full pool of ``slots`` slots, each under the profiler."""
    from repro_torch.models import transformer as T

    cfg = cfg.with_(use_pallas=True)
    dev = params["embed"].device
    bucket = 1 << (len(tokens) - 1).bit_length()
    toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    toks[0, :len(tokens)] = torch.tensor(tokens)
    last = torch.tensor([len(tokens) - 1], device=dev)
    profile_call(torch, f"prefill of {len(tokens)} tokens (bucket {bucket})",
                 lambda: T.prefill_at(cfg, params, {"tokens": toks}, last))
    caches = T.init_caches(cfg, slots, max_seq, getattr(torch, cfg.dtype), dev)
    cur = torch.arange(slots, device=dev)
    pos = torch.full((slots,), len(tokens), dtype=torch.int32, device=dev)
    profile_call(torch, f"decode step over {slots} slots at position {len(tokens)}",
                 lambda: T.decode_step_slots(cfg, params, cur, pos, caches))


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
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:     # one nvcc per source
        libs = dict(zip(build.SOURCES, pool.map(lambda n: build.build(n, verbose=True),
                                                build.SOURCES)))
    print(f"# build: {time.perf_counter() - t0:.1f} s ({', '.join(sorted(libs))})")
    gauss_instr = gauss_instructions(libs["zo_direction"])

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
    print("# phase: flash attention vs its plain version on the card")
    flash = flash_phase(torch, dev)
    print("# phase: serving qwen3-14b at full width and depth (kernel vs plain path)")
    serve = serve_phase(torch, dev)
    print("# phase: profiles of one 1000-token prefill and one decode step")
    serve_profiles(torch, serve["cfg"], serve["params"], max(serve["prompts"], key=len))

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
    head = flash["rows"][-1]                  # the serving shape at S=2048
    check(serve["launches"]["flash_attention"] > 0, "flash_attention was not launched")
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_REPLACES, "launches": serve["launches"]["flash_attention"],
        "max_abs_err": flash["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "path": "serve qwen3-14b prefill",
        "shape": "B=1 S=2048 H=40 KV=8 hd=128 bf16 causal",
        "by_length": [{k: r[k] for k in ("S", "ms", "plain_ms", "library_ms", "bound_ms")}
                      for r in flash["rows"]],
    })
    print(f"# total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
