#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases (any failed check exits non-zero):
  1. device: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: nvcc compiles the kernels from ``src/repro_torch/kernels/csrc``,
     and cuobjdump's SASS gives the instructions of one Gaussian, of one
     expf, and the scan kernel's own instructions per (t, d, s) in its step
     loop (each n = 16 variant) beside the bound's count; ptxas's registers
     and spills of every ZO kernel (the kernels of zo_reconstruct_update,
     zo_reconstruct_flat, zo_perturb_flat and zo_sumsq must not spill); then
     the Gaussian's parts timed apart: probes on zo_perturb's
     grid with no load and no store (the loop alone, the two hashes, the
     hashes and uniforms, log and sqrt, cos, the whole Gaussian with 1, 2, 4
     and 8 lanes per thread) back to back at n = 1,690,000 and 4n, each
     beside its instructions per lane by pipe from its loop in the SASS and
     the share of the issue rate at the SM clock measured here;
  3. kernels: the kernels' Gaussian against libdevice's logf/sqrtf/cosf on
     all 2^24 values of each uniform (with a control); each CUDA kernel
     against its plain PyTorch version on the card, at the Fig. 2 packed
     shape (437 blocks of 4096, m=4) and a ragged layout (leaves of 1, 7,
     4095, 4097 and 70200 values, one bf16), over acc_dtype {fp32, bf16} and
     momentum {0, 0.9}; zo_perturb_sumsq also at a block of 257, past the L2
     (4096 blocks of 4096) and off a 16-byte boundary; zo_reconstruct_update
     and zo_reconstruct_flat at m in {1, 2, 3, 4, 5, 8} and, with
     zo_perturb_flat, at a block of 257 on a buffer whose 16-byte vectors
     cross blocks' edges (random salts, counters, valid lanes and bf16
     blocks; at a 16-byte boundary and 4 bytes past one; zo_perturb_flat
     into a caller's buffer with canaries), all three required bit for bit
     equal to their plain versions; with controls
     (faulty outputs that must fail each check, among them another worker's
     v, workers 0 and 1's coefficients swapped, and the next block's salts
     across a vector's edge); kernel and plain times (CUDA events, median of
     20 after warm-up; for the redesigned ZO kernels also back to back, the
     per-call floor and the fills of mu and lr that the binding no longer
     runs) and the bound, the larger of bytes over the HBM rate and
     Gaussians x instructions over the issue rate; zo_reconstruct_update's
     and zo_reconstruct_flat's unrolled kernels for m = 4 against their
     runtime-m kernels (a build of the same source with the other choice
     for each, the update shipping the unrolled kernel and the sum the
     runtime loop; the same output bit for bit, timed in turns; fails if
     the choice not shipped is more than 5% faster);
  4. Fig. 2 main path: HO-SGD on covtype at hidden=1300 (d=1,771,907), m=4,
     B=64, tau=8, 32 steps, engine="flat" with plain SGD, through
     ``apps.classification.run_comparison``; held against engine="fused"
     (plain PyTorch on the card, no kernels) and, at hidden=64, against the
     CPU run;
  5. the generic flat path: the same model with Adam, where the flat engine
     runs ``zo_perturb_flat``/``zo_reconstruct_flat``;
  6. Fig. 1: the universal attack (d=900), 16 steps with engine="flat";
  7. per-leaf kernels (zo_perturb, zo_reconstruct, zo_sumsq) against their
     plain versions at the Fig. 2 leaf sizes (7, 1300, 1300, 9100, 70200,
     1690000) and ragged ones (1, 4095, 4097, 5000), offsets 0 and 12345,
     x in float32/bfloat16, acc_dtype float32/bfloat16, m in {1, 4}, a
     split leaf, zo_sumsq also at an offset where its counters wrap (2^32 -
     1000, and a split leaf there), zo_perturb on views off a 16-byte
     boundary, with controls (tail mask dropped, stores past the leaf,
     offset ignored, float32 accumulator for bfloat16), and their times at
     the w2 leaf (n=1,690,000; zo_perturb also at every Fig. 2 leaf size and
     back to back, zo_sumsq back to back and each of its launches alone);
  8. the Fig. 2 method set: all seven methods through
     ``run_comparison(..., engine="pallas")`` at hidden=1300, 32 steps, with
     HO-SGD's per-leaf launch counts, HO-SGD pallas against fused and
     against its round program, comm_bytes and CommLedger totals against
     the closed forms, the analytic meters, and port against port at
     hidden=64 (card against CPU); then a profile of the pallas ZO step;
  8b. federated partial participation at hidden=1300: fed-HO-SGD (K=4 of
     N=1000 clients, availability 0.75, tau=8, 16 rounds) through
     ``RoundExecutor`` with engine flat and pallas against tree (losses
     bit for bit), every ZO round booking 4 bytes per live client and every
     FO round 4*d, then 4 FedAvg rounds (local_steps=2) booking 4*d per
     live client; launch counts per run and ms per round;
  8c. HO-SGD through ``make_distributed_ho_sgd`` at hidden=1300, m=4, B=64,
     tau=8: (a) one process holding the four workers (a one-rank gloo
     group; flat + SGD, the fused kernels), 32 steps, losses equal to
     ``make_ho_sgd``'s flat path bit for bit; (b) four gloo ranks spawned
     on cuda:0, one per worker (``zo_perturb_flat``/``zo_reconstruct_flat``),
     16 steps, losses within rtol 1e-6 of (a) and rank 0's parameters within
     2% of the update of (a)'s after 16 steps, rank 0's ledger at 4*m bytes
     per ZO step and 4*d per FO step; a rank that fails or hangs fails the
     run; ms per FO and ZO step of each;
  8d. the LLM trainer, ``launch.train.main``, on the card: (a) gemma2-2b at
     full width and depth (d = 2,614,341,888, bf16, grad_accum 8),
     ``--engine flat``, 6 steps at tau 3, batch 8, seq 128: finite losses,
     the order F Z Z F Z Z, 4*d bytes per FO step and 4 per ZO step, one
     zo_perturb_flat and one zo_reconstruct_flat launch per ZO step, the
     first ZO step's kernel outputs against the plain versions on sampled
     blocks of every leaf and past element 2^31 (rtol 1e-5 of the change),
     the trace's spans against the CSV; ms and peak memory per step kind,
     and the last ZO step profiled and split by CUDA events into the plain
     sums of squares, the loss forwards and the kernels; then both flat
     kernels timed at that packed buffer beside their bounds; (b) 100m
     (float32, d = 75,522,816), 8 steps with engine flat, pallas and tree:
     in the first ZO step the flat kernels held on sampled blocks and the
     per-leaf ones on the first, middle and last 4096 elements of every
     leaf (rtol 1e-5 of the change), losses equal to tree's bit for bit,
     the flat run's ``--ckpt`` restored bit for bit on the card; (c) the
     same 8 steps on arctic-480b (MoE: 8 experts, top-2, the dense
     residual; batch 16 for its grad_accum 16) and hymba-1.5b (hybrid) at
     ``--reduce 100m``, float32, flat, pallas and tree, held as (b), and
     arctic's first loss evaluation held to its cross-entropy plus 0.01
     times the layers' aux loss, each computed apart;
  8d'. sharded placements (``launch.train.main`` on gloo ranks that share
     cuda:0, their gathers device to device): (a) gemma2-2b at full width
     with ``--model-axis 2`` (2 ranks), F Z Z: steps 0-1 bit for bit 8d
     (a)'s losses, step 2 within rtol 1e-6, each rank holding only its
     shards and peaking below 8d (a)'s one-process peak, rank 0 booking 4*d
     and 4 bytes, rows 3-4 held on sampled blocks of rank 0's packed shard
     (a column-sharded leaf's and the row-sharded embedding's among them)
     with shard-local counters as a failing control; (b) at ``--reduce
     100m`` on (data=2, model=2) (4 ranks), 8 steps at tau 4: gemma2-2b
     (m = 2) and arctic-480b (fsdp, MoE; m = 1) against the replicated run
     of the same config in this process, losses within rtol 1e-6 and rank
     0's final shards within 2% of the update; ms per FO and ZO step and
     the gathers' share of each by host clock;
  8d''. the launch tooling held to this run: ``launch.dryrun.run_one``
     prices (a) 8d (a)'s configuration on one rank and (b) rank 0 of 8d''s
     (a) mesh, an FO and a ZO step each, in four spawned processes on the
     CPU (a fake process group, ``meta`` tensors): each predicted peak
     within 10% of the card's first step of that kind, (b)'s gathered bytes
     of an FO step equal to rank 0's; (c) one FO step of gemma2-2b at 100m
     on 2 gloo ranks (``--model-axis 2``) traced by ``torch.profiler`` on
     rank 0: ``launch.overlap.overlap_stats``' pairs equal to the gathers
     counted in the step; (d) ``bench.kernels_bench --smoke``: every kernel
     row within its tolerance of its plain version;
  8e. the cluster simulator, ``make_sim_methods`` + ``simulate``, at Fig. 2's
     width (hidden=1300, m=4, B=64, tau=8, 32 iterations) on
     bandwidth-constrained flat clusters: (a) HO-SGD, sync-SGD, ZO-SGD; (b)
     HO-SGD with failures rolled back to checkpoints, and elastic; (c)
     max_staleness 2; (d) fed-HO-SGD over 1000:4 clients; each on engine
     flat and tree: trace, orders, bytes (4 per live worker on ZO rounds,
     4*d on FO rounds), membership, failures and rejoins equal; every ZO
     call's parameter change within 2% of tree's from the same inputs (a
     zeroed reconstruction is the failing control), the final parameters
     within 2% of tree's change over runs with FO rounds; the fused pair
     launched on full synchronous rounds, zo_perturb_flat and
     zo_reconstruct_flat on the executor's; (c) twice bit for bit and once
     monolithic; host ms per replayed call; the simulated summary;
  8f. open-loop serving traffic: ``launch.serve.main --traffic
     poisson:50.0,mixed`` on qwen3-14b at full width and depth (32
     requests, 8 slots): the 64-token buckets' prefills through the bf16
     flash kernel; the CSV and trace against the result; a second replay
     on the same weights identical; requests, tokens and arrivals equal to
     ``replay_seed_sync``'s; replay wall time, decode steps and their
     device-clock time; the simulated tok/s and TTFT;
  9. flash attention: both kernels against the plain version: the bf16
     tensor-core kernel at the serving shapes (B=1, H=40, KV=8, hd=128,
     causal, S in {64, 512, 1024, 2048}) and at every head width (gemma2's
     hd=256 with window 4096 and softcap 50, phi3's hd=96, hd=64, hd=32 with
     a window, causal off, tiles half past Sq, Sq != Sk), the float32 TF32x3
     kernel (three TF32 products per matrix product) at the serving shape
     at S=2048, at S=4096 without a causal mask, gemma2's and three other
     shapes; hubert-xlarge's head width
     80 (causal and not) and B * H = 70,400 on both kernels; each launch
     counted under its variant; controls (the KV head h % KV, the causal
     mask dropped, the probabilities rounded to bf16 once instead of split,
     and for float32 S or P.V with two TF32 products instead of three);
     kernel, plain and ``scaled_dot_product_attention`` times, TFLOP/s and
     the bound, bf16 at every serving S and float32 at S=2048;
  10. serving qwen3-14b at full width and depth (random bf16 weights from a
     seeded generator on the card): 8 seeded prompts of 65-1000 tokens
     through ``Engine.generate`` at temperature 0, 8 slots, 32 new tokens,
     once through the kernel (use_pallas) and once through the plain path,
     with launch counts (every flash launch the bf16 tensor-core kernel's),
     logits and greedy tokens held against each other,
     prefill and decode times, and profiles of one prefill and one decode
     step;
  11. the selective scan, RMSNorm and flash attention at hd=80: each CUDA
     kernel against its plain version (the scan's y and final state at
     falcon-mamba-7b's width, B=1, di=8192, n=16, S in {64, 256, 1024},
     bf16, ragged di and S, every n template, n = 96 and 128 in groups, B =
     70,000; RMSNorm at (1024, 4096) bf16, (1000, 5120) float32, (1024,
     12288) bf16, ragged rows and rows past 8192), with controls (the scan's
     state reset at every tile, D*u dropped, C_t read a step late, the final
     state one step early; RMSNorm without (1 + scale), or over all rows);
     the scan's n = 16 variants (2, 4, 8 lanes per channel) timed in turns
     at every S; kernel, plain and (for RMSNorm) ``F.rms_norm`` times and
     the bound, the scan's expf counted from its SASS; RMSNorm's path,
     ``ops.rmsnorm``, with launches; flash attention at hubert-xlarge's
     widths (B=1, S=1024, H=16, hd=80, no causal mask, bf16) beside SDPA;
  12. serving falcon-mamba-7b at full width and depth (7,006,588,928 random
     bf16 parameters, after qwen3-14b's are freed): 8 seeded prompts whose
     lengths are multiples of 64 in [64, 1024], exact-length prefills, as
     in phase 10 through the scan kernel and through the plain path;
  13. profiles of one 1024-token falcon-mamba prefill on each path (the
     scan kernel's share; the plain tail-state scan's calls, 0 through the
     kernel, which gives the state, and one per layer on the plain path;
     device time and peak memory of each) and one decode step over 8 slots;
  14. serving qwen3-moe-235b-a22b at full width (d_model 4096, 64/4 heads,
     128 experts, top-8, expert d_ff 1536), depth cut to 4 layers
     (11,195,683,840 random bf16 parameters), as phase 10: 32 flash
     launches, all the bf16 tensor-core kernel at hd 128; the prefills'
     routes of the two runs compared; one 1000-token prefill and one decode
     step profiled and split by CUDA events into attention, expert
     products, dispatch and the rest; the expert weights a decode step
     reads beside their least time; flash at its head layout (S=1024,
     H=64, KV=4) is held and timed in phase 9;
  15. serving hymba-1.5b at full width and depth (1,662,264,000 random
     bf16 parameters) as phase 12: 32 scan launches per prefill, its
     attention plain on both paths (its windows differ by layer); one
     1024-token prefill's k, v, conv and ssm caches through the kernel held
     against the plain path's;
  16. pixtral-12b (1024 image embeddings and 1024 tokens) and
     hubert-xlarge (1024 features) at full width and depth, bf16:
     ``forward_logits`` and ``loss_fn`` through the flash kernel (causal;
     hubert non-causal at hd=80) and the plain path: launches per layer,
     logits within 5% of the plain path's largest, the losses' relative
     difference, ms and peak memory.
The last two lines are the kernels JSON and the device JSON.  Launch counts
are set to 0 just before each path and read just after it; each ZO kernel's
entry also carries its launches on the paths of phases 8b-8e
(``launches_by_path``, with phase 8d's (c) runs and 8d''s runs), flash attention's on
phases 8f, 14 and 16 and the scan's on phase 15;
zo_perturb_flat's and zo_reconstruct_flat's also
their times at gemma2-2b's packed buffer (``gemma2_2b``).
"""
from __future__ import annotations

import contextlib
import functools
import gc
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
TF32_OPS_PER_S = 495e12      # H100 SXM dense TF32 tensor-core rate
CUDA_SRC = "src/repro_torch/kernels/csrc/zo_direction.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:111"
SERVE_SHAPES = (64, 512, 1024, 2048)     # prefill lengths timed at the serving shape
SCAN_SRC = "src/repro_torch/kernels/csrc/selective_scan.cu"
SCAN_REPLACES = "src/repro/kernels/selective_scan.py:72"
SCAN_SHAPES = (64, 256, 1024)            # prefill lengths timed at falcon-mamba-7b's width
RMSNORM_SRC = "src/repro_torch/kernels/csrc/rmsnorm.cu"
RMSNORM_REPLACES = "src/repro/kernels/rmsnorm.py:28"
# what each serving kernel's output is, for the tolerance note
ROUNDED = {"flash_attention": "attention output",
           "selective_scan": "scan output (a sequential recurrence against an associative "
                             "scan)"}
REPLACES = {
    "zo_perturb_sumsq": "src/repro/kernels/zo_direction.py:349",
    "zo_reconstruct_update": "src/repro/kernels/zo_direction.py:447",
    "zo_perturb_flat": "src/repro/kernels/zo_direction.py:236",
    "zo_reconstruct_flat": "src/repro/kernels/zo_direction.py:275",
}
LEAF_REPLACES = {
    "zo_perturb": "src/repro/kernels/zo_direction.py:136",
    "zo_reconstruct": "src/repro/kernels/zo_direction.py:183",
    "zo_sumsq": "src/repro/kernels/zo_direction.py:104",
}
FIG2_LEAVES = (7, 1300, 1300, 9100, 70200, 1690000)   # the MLP's six leaves
RAGGED_LEAVES = (1, 4095, 4097, 5000)
# what a ZO kernel's row carries beside the contract's keys, where it has it
EXTRA_KEYS = ("sumsq_rel_err", "gauss_instructions", "launches_per_call", "stream_ms",
              "floor_ms", "mu_fill_stream_ms", "lr_fill_stream_ms", "launch_stream_ms",
              "compute_only_ms", "uniforms_only_ms", "by_size", "bitwise_diff_lanes",
              "host_scale_ms", "lanes_compared", "registers", "gauss_probes", "unrolled_m_ab")
UNROLLED_M = 4               # the reconstruct kernels' m with kernels of its own (kUnrolledM)
METHODS = ["ho_sgd", "sync_sgd", "ri_sgd", "pa_sgd", "zo_sgd", "zo_svrg_ave", "qsgd"]
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


def stream_ms(torch, fn, calls: int = 50, reps: int = 5) -> float:
    """Device time of one call of ``fn`` when ``calls`` of them run back to
    back (CUDA events around the run, behind a sleep kernel; median of
    ``reps`` runs): each launch is set up while the one before it runs, so
    this leaves out the per-call floor that ``cuda_ms`` includes.  The
    buffers stay in the L2 from call to call where they fit."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return statistics.median(times)


def floor_ms(torch, dev) -> float:
    """``cuda_ms`` of a fill of one value: what the timing gives a kernel that
    does next to nothing (its launch and the events)."""
    one = torch.empty(1, device=dev)
    return cuda_ms(torch, lambda: one.fill_(1.0))


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


def probe_instructions(lib: Path, probe: str, base: str, what: str, least: int) -> int:
    """Instructions of ``what``: the shortest SASS path of the kernel
    ``probe`` less that of ``base`` (the same kernel without it), read from
    the library that was just built."""
    funcs = sass_functions(sass_text(lib))
    check({probe, base} <= set(funcs),
          f"probe kernels missing from the SASS ({sorted(funcs)[:8]})")
    g, b = shortest_path(funcs[probe]), shortest_path(funcs[base])
    print(f"# {what}: {g - b} instructions on the shortest SASS path "
          f"({probe} {g} - {base} {b}; {probe} holds "
          f"{len(funcs[probe])} instructions in all)")
    check(g - b > least, f"implausible instruction count for {what}")
    return g - b


def gauss_instructions(lib: Path) -> int:
    """Instructions of one IEEE Gaussian (probes ``zo_probe_gauss`` and
    ``zo_probe_base``)."""
    return probe_instructions(lib, "zo_probe_gauss", "zo_probe_base", "one Gaussian", 10)


def uniforms_instructions(lib: Path) -> int:
    """Instructions of the Gaussian's hash and two uniforms alone (probes
    ``zo_probe_uniforms`` and ``zo_probe_base``)."""
    return probe_instructions(lib, "zo_probe_uniforms", "zo_probe_base",
                              "the hash and two uniforms", 5)


def scan_loop_instructions(lib: Path, lanes: int, states: int, exp_instr: int, n: int) -> dict:
    """The scan kernel's own SASS per (t, d, s), for the float32 template
    with ``lanes`` lanes per channel and ``states`` states per lane.

    How it is counted: the step loop is the innermost backward branch of the
    kernel whose body holds MUFU.EX2 (the special-function instruction of
    each expf); every instruction of the body (predicated ones too: they take
    an issue slot) is divided by the body's MUFU.EX2, one per (t, d, s) a
    lane runs.  The tile loop around it (staging, the barrier, the write-back
    of y) is the innermost backward branch that holds the step loop; its
    other instructions are spread over the tile's kTT * states triples a
    lane runs, kTT (time steps per tile) read from the template's name.  The
    bound counts exp_instr + 6 per triple and 2 per (t, d)."""
    key = re.compile(rf"selective_scan_kernelIfLi{lanes}ELi{states}ELi(\d+)ELb0E")
    funcs = sass_functions(sass_text(lib))
    names = [(f, m) for f in funcs for m in [key.search(f)] if m]
    check(len(names) == 1, f"the scan template {key.pattern} is not in the SASS once "
          f"({[f for f, _ in names]})")
    kTT = int(names[0][1].group(1))
    instrs = funcs[names[0][0]]
    index = {addr: k for k, (addr, *_) in enumerate(instrs)}
    loops = []                              # (first, last) index of each backward branch
    for k, (addr, _, op, args) in enumerate(instrs):
        hexes = re.findall(r"0x[0-9a-f]+", args)
        if op.startswith("BRA") and hexes and int(hexes[-1], 16) < addr:
            loops.append((index[int(hexes[-1], 16)], k))

    def count(lo, hi):
        body = [op for _, _, op, _ in instrs[lo:hi + 1] if not op.startswith("NOP")]
        return len(body), sum(op.startswith("MUFU.EX2") for op in body)

    steps = [(hi - lo, lo, hi) for lo, hi in loops if count(lo, hi)[1] > 0]
    check(bool(steps), "no loop with an expf in the scan kernel's SASS")
    _, lo, hi = min(steps)
    n_in, ex_in = count(lo, hi)
    tiles = [(h2 - l2, l2, h2) for l2, h2 in loops if l2 <= lo and h2 >= hi and (l2, h2) != (lo, hi)]
    per_step = n_in / ex_in
    with_tile = None
    if tiles:
        _, l2, h2 = min(tiles)
        trips = kTT * states / ex_in
        with_tile = ((count(l2, h2)[0] - n_in) + n_in * trips) / (kTT * states)
    bound = exp_instr + 6 + 2 / n
    tile_text = (f"{with_tile:.3f} with the tile loop's staging, barrier and write-back"
                 if with_tile is not None else "the step loop is the tile loop")
    print(f"# scan kernel SASS (float32, {lanes} lanes x {states} states): step loop "
          f"{n_in} instructions for {ex_in} expf = {per_step:.3f} per (t, d, s); "
          f"{tile_text}; the bound counts {exp_instr} + 6 + 2/{n} = {bound:.3f} "
          f"(ratio {per_step / bound:.3f})")
    return {"lanes": lanes, "states": states, "tile_steps": kTT, "step_loop": n_in, "expf": ex_in,
            "per_triple": per_step, "per_triple_with_tile": with_tile, "bound_per_triple": bound}


@functools.lru_cache(maxsize=None)
def sass_text(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library (read once per library)."""
    from repro_torch.kernels.build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    return out.stdout


def pipe_of(op: str) -> str:
    """The unit a SASS instruction issues to, by our reading of NVIDIA's
    throughput table for compute capability 9.0 (per SM and clock): "fma"
    (float32 add, multiply, multiply-add at 128; integer multiply-add at 64),
    "alu" (integer add, logic, shift, compare, select, and I2FP, at 64),
    "xu" (MUFU and the other conversions, at 16), "other" (branches, memory,
    uniform-datapath and special registers)."""
    base = op.split(".")[0]
    if base in ("MUFU", "F2I", "I2F", "F2F", "FRND", "I2I"):
        return "xu"
    if base in ("FFMA", "FMUL", "FADD", "IMAD", "HFMA2", "IMUL", "IDP"):
        return "fma"
    if base in ("LOP3", "IADD3", "SHF", "ISETP", "FSETP", "FSEL", "SEL", "LEA", "PRMT", "I2FP",
                "F2FP", "FMNMX", "IMNMX", "IABS", "PLOP3", "P2R", "R2P", "MOV", "VIADD",
                "IADD", "SHL", "SHR", "LOP", "FLO", "POPC", "BREV", "VIMNMX"):
        return "alu"
    return "other"


def loop_trip(instrs) -> list:
    """The opcodes of one trip of a probe kernel's loop: the shortest cycle
    from the loop's head (the earliest target of a backward branch) back to
    it, so the rarely taken store is left out wherever the compiler put it;
    predicated instructions count (they take an issue slot), NOPs do not."""
    import heapq

    index = {addr: k for k, (addr, *_) in enumerate(instrs)}

    def target(args):
        return index[int(re.findall(r"0x[0-9a-f]+", args)[-1], 16)]

    backs = [target(args) for k, (addr, _, op, args) in enumerate(instrs)
             if op.startswith("BRA") and re.findall(r"0x[0-9a-f]+", args) and target(args) < k]
    check(bool(backs), "a probe kernel has no loop in its SASS")
    head = min(backs)
    dist, prev, heap, best = {head: 0}, {}, [(0, head)], None
    while heap:
        d, k = heapq.heappop(heap)
        if d > dist[k]:
            continue
        _, pred, op, args = instrs[k]
        base = op.split(".")[0]
        cost = 0 if base == "NOP" else 1
        nxt = []
        if base == "BRA":
            nxt.append(target(args))
            if pred or "," in args:
                nxt.append(k + 1)
        elif base not in ("EXIT", "RET") or pred:
            nxt.append(k + 1)
        for j in nxt:
            if j == head:
                if best is None or d + cost < best[0]:
                    best = (d + cost, k)
            elif j < len(instrs) and d + cost < dist.get(j, math.inf):
                dist[j], prev[j] = d + cost, k
                heapq.heappush(heap, (d + cost, j))
    check(best is not None, "no cycle through a probe kernel's loop head")
    path, k = [], best[1]
    while True:
        path.append(instrs[k][2])
        if k == head:
            break
        k = prev[k]
    return [op for op in path if not op.startswith("NOP")]


def probe_loops(lib: Path) -> dict:
    """{(part, k): (instructions per lane on one trip, {pipe: per lane})} of
    the timing probes ``probe_part_kernel<part, k>`` in the built SASS."""
    from repro_torch.kernels import zo_direction as cu

    names = {v: k for k, v in cu.PROBE_PARTS.items()}
    key = re.compile(r"probe_part_kernelILi(\d+)ELi(\d+)E")
    out = {}
    for fname, instrs in sass_functions(sass_text(lib)).items():
        m = key.search(fname)
        if not m:
            continue
        part, k = names[int(m.group(1))], int(m.group(2))
        trip = loop_trip(instrs)
        pipes = {}
        for op in trip:
            pipes[pipe_of(op)] = pipes.get(pipe_of(op), 0) + 1 / k
        out[(part, k)] = (len(trip) / k, pipes)
    return out


def ptxas_lines(name: str) -> dict:
    """Print and return each kernel's registers and spills (``-Xptxas -v``),
    names demangled with the toolkit's cu++filt where it has one."""
    from repro_torch.kernels.build import find_nvcc, ptxas_usage

    usage = ptxas_usage(name)
    filt = Path(find_nvcc()).parent / "cu++filt"
    names = list(usage)
    if filt.exists() and names:
        out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True,
                             timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    rows = {}
    for mangled, pretty in zip(usage, names):
        short = re.sub(r"\((?:int|bool|unsigned int)\)|^void |\(anonymous namespace\)::|"
                       r"<unnamed>::", "", pretty).split("(")[0]
        u = usage[mangled]
        rows[short] = u
        print(f"#   ptxas {short}: {u.get('registers')} registers, stack {u.get('stack')} B, "
              f"spill stores {u.get('spill_stores')} B, loads {u.get('spill_loads')} B")
    return rows


def build_m_variant() -> Path:
    """``zo_direction.cu`` with the other choice of kernel for each
    reconstruct epilogue at m = ``UNROLLED_M`` (``unrolled_m``, the one place
    both dispatches ask): the update's runtime loop, the stored sum's
    unrolled kernel.  Built with the port's flags beside its libraries: the
    A/B that keeps each shipped choice."""
    import hashlib

    from repro_torch.kernels import build as kb

    src = kb.SOURCES["zo_direction"].read_text()
    old = ("inline bool unrolled_m(int m, int epi) { return m == kUnrolledM && "
           "epi != kStoreSum; }\n")
    check(src.count(old) == 1 and f"constexpr int kUnrolledM = {UNROLLED_M};" in src,
          f"the m-variant build does not find the reconstruct kernels' dispatch (unrolled "
          f"kernel for the update at m = {UNROLLED_M}, runtime loop for the sum) in "
          f"zo_direction.cu")
    src = src.replace(old, old.replace("epi != kStoreSum", "epi == kStoreSum"))
    h = hashlib.sha256((src + " ".join(kb.NVCC_FLAGS)).encode()).hexdigest()[:16]
    out = kb.build_dir() / f"libzo_direction_m_variant_{h}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        out.with_suffix(".cu").write_text(src)
        proc = subprocess.run([kb.find_nvcc(), *kb.NVCC_FLAGS, "-o", str(out),
                               str(out.with_suffix(".cu"))], capture_output=True, text=True,
                              timeout=900)
        check(proc.returncode == 0, f"the m-variant build failed: {proc.stderr[-3000:]}")
    return out


def unrolled_m_ab(torch, lib: Path, x, sm, ctr, nv, bf, coeffs, lr, block, margin=0.05) -> dict:
    """At the Fig. 2 shape (m = ``UNROLLED_M``), each reconstruct kernel's
    shipped choice against the other one (``build_m_variant``):
    zo_reconstruct_update ships the unrolled kernel, zo_reconstruct_flat the
    runtime-m one.  Bit for bit the same output, then the two timed in turns
    (runtime, unrolled, unrolled, runtime), back to back and one call at a
    time.  Fails when the choice not shipped is more than ``margin`` faster
    back to back, and warns when the shipped one leads by under 1%.
    Returns {kernel name: its A/B}."""
    import ctypes

    from repro_torch.kernels import zo_direction as cu

    m = int(coeffs.numel())
    check(m == UNROLLED_M, f"the m A/B needs m = {UNROLLED_M}, got {m}")
    variant = ctypes.CDLL(str(lib))
    for entry in ("zo_reconstruct_update_launch", "zo_reconstruct_flat_launch"):
        fn = getattr(variant, entry)
        fn.argtypes, fn.restype = cu._SIGNATURES[entry], ctypes.c_int
    dev = x.device

    def ran(rc):
        check(rc == 0, f"the m-variant kernel's launch failed: CUDA error {rc}")

    flat_args = lambda o: (sm.data_ptr(), coeffs.data_ptr(), ctr.data_ptr(),   # noqa: E731
                           nv.data_ptr(), o.data_ptr(), o.numel(), block, m, 0, x.device.index,
                           cu._stream(dev))
    shipped_unrolled = {"zo_reconstruct_update": True, "zo_reconstruct_flat": False}
    pairs = {       # (shipped, variant), each writing into the buffer it is given
        "zo_reconstruct_update": (
            lambda p: cu.zo_reconstruct_update(p, None, sm, ctr, nv, bf, coeffs, lr, 0.0, block,
                                               "float32"),
            lambda p: ran(variant.zo_reconstruct_update_launch(
                p.data_ptr(), None, sm.data_ptr(), ctr.data_ptr(), nv.data_ptr(), bf.data_ptr(),
                coeffs.data_ptr(), lr, 0.0, p.numel(), block, m, 0, x.device.index,
                cu._stream(dev)))),
        "zo_reconstruct_flat": (
            lambda o: cu._launch("zo_reconstruct_flat", "zo_reconstruct_flat_launch",
                                 *flat_args(o)),
            lambda o: ran(variant.zo_reconstruct_flat_launch(*flat_args(o)))),
    }
    abs_ = {}
    for name, (shipped, other) in pairs.items():
        unrolled, runtime = (shipped, other) if shipped_unrolled[name] else (other, shipped)
        a, b = x.clone(), x.clone()
        runtime(a)
        unrolled(b)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"{name}: the runtime-m kernel's output differs from the "
              f"unrolled kernel's")
        work = x.clone()
        r1, u1 = stream_ms(torch, lambda: runtime(work)), stream_ms(torch, lambda: unrolled(work))
        u2, r2 = stream_ms(torch, lambda: unrolled(work)), stream_ms(torch, lambda: runtime(work))
        c_r1, c_u1 = cuda_ms(torch, lambda: runtime(work)), cuda_ms(torch, lambda: unrolled(work))
        c_u2, c_r2 = cuda_ms(torch, lambda: unrolled(work)), cuda_ms(torch, lambda: runtime(work))
        ab = {"m": m, "shipped": "unrolled" if shipped_unrolled[name] else "runtime_m",
              "runtime_m_stream_ms": (r1 + r2) / 2, "unrolled_stream_ms": (u1 + u2) / 2,
              "runtime_m_ms": (c_r1 + c_r2) / 2, "unrolled_ms": (c_u1 + c_u2) / 2,
              "turns_stream_ms": [r1, u1, u2, r2]}
        lead = ab["runtime_m_stream_ms"] / ab["unrolled_stream_ms"] - 1
        ab["unrolled_lead"] = lead
        shipped_lead = lead if shipped_unrolled[name] else -lead
        print(f"  {name:22s} m = {m}, the unrolled kernel vs the runtime-m kernel (same output "
              f"bit for bit; {ab['shipped']} ships): back to back "
              f"{ab['unrolled_stream_ms']:.5f} vs {ab['runtime_m_stream_ms']:.5f} ms (turns "
              f"runtime/unrolled/unrolled/runtime {r1:.5f} {u1:.5f} {u2:.5f} {r2:.5f}), one call "
              f"{ab['unrolled_ms']:.4f} vs {ab['runtime_m_ms']:.4f} ms; the unrolled kernel "
              f"leads by {lead:.2%}")
        if shipped_lead < 0.01:
            print(f"  WARNING {name}: the shipped {ab['shipped']} kernel for m = {m} leads the "
                  f"other by {shipped_lead:.2%} only")
        check(shipped_lead >= -margin, f"{name}: the kernel not shipped for m = {m} is "
              f"{-shipped_lead:.2%} faster than the shipped {ab['shipped']} one (more than "
              f"{margin:.0%})")
        abs_[name] = ab
    return abs_


def sm_clock_ghz(torch) -> float:
    """The SM clock the card runs at, from a spin of 20M clock cycles
    (``torch.cuda._sleep``) timed with CUDA events."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(cycles)
    e.record()
    torch.cuda.synchronize()
    return cycles / (s.elapsed_time(e) * 1e-3) / 1e9


PROBES = [("loop", 4), ("hashes", 4), ("uniforms", 4), ("log_sqrt", 4), ("cos", 4),
          ("gauss", 1), ("gauss", 2), ("gauss", 4), ("gauss", 8)]
SMSPS = 132 * 4               # the H100 SXM's SM sub-partitions, one warp issued per clock each


def gauss_probe_phase(torch, dev, lib: Path, n=1_690_000):
    """What holds the Gaussian: each part of gauss() alone, and the whole
    Gaussian with 1, 2, 4 and 8 independent lanes per thread, on
    zo_perturb's grid with no load and no store, timed back to back at n and
    4n lanes; the difference gives the rate without the launch's fixed cost.
    Beside each: its own instructions per lane on one trip of its loop in
    the SASS, by pipe, and the share of the issue rate it runs at (one warp
    instruction per sub-partition and clock, at the clock measured here)."""
    from repro_torch.kernels import zo_direction as cu

    loops = probe_loops(lib)
    check(set(PROBES) <= set(loops), f"probe kernels missing from the SASS: {sorted(loops)}")
    ghz = sm_clock_ghz(torch)
    print(f"  SM clock {ghz:.3f} GHz (a spin of 20M cycles); one warp instruction per "
          f"sub-partition and clock is {SMSPS * 32 * ghz / 1e3:.2f}T lane-instructions/s")
    rows = []
    for part, k in PROBES:
        t1, t4 = (stream_ms(torch, lambda nn=nn: cu.probe_part(nn, part, k, dev))
                  for nn in (n, 4 * n))
        per_lane, pipes = loops[(part, k)]
        slope_ns = (t4 - t1) * 1e6 / (3 * n)              # ns per lane, fixed cost out
        cycles = slope_ns * ghz * SMSPS * 32             # sub-partition cycles per 32 lanes
        row = {"part": part, "k": k, "instructions_per_lane": per_lane,
               "by_pipe": {p: round(v, 3) for p, v in sorted(pipes.items())},
               "ms_n": t1, "ms_4n": t4, "ns_per_lane": slope_ns,
               "cycles_per_warp_lane": cycles, "issue_share": per_lane / cycles}
        rows.append(row)
        print(f"  probe {part:9s} k={k}: {per_lane:6.2f} instructions per lane "
              f"({', '.join(f'{p} {v:.2f}' for p, v in sorted(pipes.items()))}); back to back "
              f"{t1:.5f} ms at n={n}, {t4:.5f} at 4n: {slope_ns * 1e3:.3f} ps per lane = "
              f"{cycles:.1f} sub-partition cycles per 32 lanes, {row['issue_share']:.3f} of "
              f"the issue rate")
    least = {"hashes": 12, "uniforms": 16, "log_sqrt": 12, "cos": 12, "gauss": 50}
    base = next(r for r in rows if r["part"] == "loop")
    for r in rows:               # no part may have been folded away by the compiler
        if r["part"] in least:
            check(r["instructions_per_lane"] - (base["instructions_per_lane"] if r["k"] == 4 else 0)
                  > least[r["part"]], f"probe {r['part']} k={r['k']}: too few instructions "
                  f"({r['instructions_per_lane']:.2f} per lane); was its work dropped?")
    for r in rows:
        if r["part"] != "loop" and r["k"] == 4:
            d_instr = r["instructions_per_lane"] - base["instructions_per_lane"]
            d_cyc = r["cycles_per_warp_lane"] - base["cycles_per_warp_lane"]
            r["over_loop"] = {"instructions": d_instr, "cycles": d_cyc}
            print(f"  probe {r['part']:9s} over the loop alone: {d_instr:6.2f} instructions, "
                  f"{d_cyc:6.1f} cycles per 32 lanes ({d_instr / d_cyc if d_cyc > 0 else 0:.3f} "
                  f"of the issue rate)")
    return {"sm_clock_ghz": ghz, "n": n, "rows": rows}


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


def sumsq_launches_ms(torch, cu, x, salts, ctrs, nvalid, block):
    """``stream_ms`` of each of zo_perturb_sumsq's two launches alone, called
    as the binding calls them."""
    dev = x.device
    v, out = cu._aligned_like(x), cu._aligned_like(x)
    parts = torch.empty(cu.MAX_PARTIALS, dtype=torch.float32, device=dev)
    ss = torch.empty(1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    first = lambda: cu._launch(                                           # noqa: E731
        "zo_perturb_sumsq", "zo_sumsq_v_launch", x.data_ptr(), salts.data_ptr(),
        ctrs.data_ptr(), nvalid.data_ptr(), v.data_ptr(), parts.data_ptr(),
        cu.MAX_PARTIALS, x.numel(), block, dev.index, stream)
    second = lambda: cu._launch(                                          # noqa: E731
        "zo_perturb_sumsq", "zo_apply_v_launch", x.data_ptr(), v.data_ptr(), parts.data_ptr(),
        cu.MAX_PARTIALS, 1e-3, out.data_ptr(), ss.data_ptr(), x.numel(), dev.index,
        stream)
    return [stream_ms(torch, first), stream_ms(torch, second)]


def leaf_sumsq_launches_ms(torch, cu, n, salt, dev):
    """``stream_ms`` of each of zo_sumsq's two launches alone at a leaf of
    ``n``, called as the binding calls them."""
    parts = torch.empty(cu.MAX_PARTIALS, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    index, stream = parts.device.index, cu._stream(parts.device)
    first = lambda: cu._launch(                                           # noqa: E731
        "zo_sumsq", "zo_sumsq_partials_launch", parts.data_ptr(), cu.MAX_PARTIALS, n, salt, 0,
        index, stream)
    second = lambda: cu._launch(                                          # noqa: E731
        "zo_sumsq", "zo_sumsq_total_launch", parts.data_ptr(), cu.MAX_PARTIALS, n,
        out.data_ptr(), index, stream)
    return [stream_ms(torch, first), stream_ms(torch, second)]


def bit_diff(torch, got, want) -> int:
    """Lanes whose float32 bits differ."""
    g, w = got.float().contiguous(), want.float().contiguous()
    return int((g.view(torch.int32) != w.view(torch.int32)).sum())


def per_lane(torch, salts, ctrs, nvalid, bf16_mask, block, n):
    """The packed layout as blocks of one lane each: lane i's salts, counter,
    valid flag and bf16 flag, so a plain version at block=1 can give a
    single lane other salts than its block's."""
    lanes = torch.arange(n, device=ctrs.device)
    b, l = lanes // block, lanes % block
    lc = ((ctrs.to(torch.int64)[b] + l) & 0xFFFFFFFF).to(torch.uint32)
    return (salts.to(torch.int64)[b], lc, (l < nvalid.to(torch.int64)[b]).to(torch.int32),
            bf16_mask[b])


def edge_fault(torch, lane_salts, salts, block, head, n):
    """A kernel's fault, as per-lane salts: every lane of a 16-byte vector
    (lanes head + 4j .. head + 4j + 3) that crosses a packed block's edge
    takes the salts of the block after the vector's first lane's.  Returns
    the faulty salts and the count of vectors that cross."""
    i0 = head + 4 * torch.arange((n - head) // 4, device=salts.device)
    starts = i0[(i0 // block) != ((i0 + 3) // block)]
    bad = lane_salts.clone()
    for k in range(4):
        bad[starts + k] = salts.to(torch.int64)[starts // block + 1]
    return bad, int(starts.numel())


def flat_perturb_into(torch, x, salts, ctrs, nvalid, scale, out, block):
    """Launch zo_perturb_flat's kernel writing into ``out`` (a caller's
    buffer, longer than x): the canary check's way in."""
    from repro_torch.kernels import zo_direction as cu

    dev = x.device
    cu._launch("zo_perturb_flat", "zo_perturb_flat_launch", x.data_ptr(), salts.data_ptr(),
               ctrs.data_ptr(), nvalid.data_ptr(), scale.reshape(1).data_ptr(), out.data_ptr(),
               x.numel(), block, dev.index, cu._stream(dev))


def kernel_phase(torch, dev, fig2_params, gauss_instr, big=(4096, 4096), edge_blocks=1300,
                 edge_ms=(1, 2, 3, 4, 5, 8), m_variant_lib=None):
    import numpy as np

    from repro_torch.core.engine import FlatEngine
    from repro_torch.kernels import ref
    from repro_torch.kernels import zo_direction as cu

    radii, cosines = cu.check_gauss(dev)
    print(f"  {'gauss':22s} radii and cosines that differ from libdevice's logf/sqrtf/cosf "
          f"on the reference's uniform, over all 2^24 values of each: {radii}, {cosines} "
          f"(must be 0, 0)")
    check(radii == 0 and cosines == 0, f"the kernels' Gaussian is not libdevice's: {radii} "
          f"radii and {cosines} cosines differ")
    ctl = cu.check_gauss(dev, control=True)[1]
    print(f"  {'gauss':22s} control, cosf one ulp further on: {ctl} cosines differ (must be > 0)")
    check(ctl > 0, "the Gaussian check lets a faulty cosine pass")

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
    coeffs8 = torch.tensor([0.5, -1.0, 2.0, 0.1, 0.7, -0.3, 1.2, -0.8], device=dev)
    lr = 0.05
    errs = {k: 0.0 for k in REPLACES}
    bits = {k: [0, 0] for k in ("zo_perturb_flat", "zo_reconstruct_update",   # differ, lanes
                                "zo_reconstruct_flat")}
    sumsq_rel = 0.0

    def compare(name, got, want, what, **kw):
        ok, err, tol = agree(torch, got, want, **kw)
        extra = ""
        if name in bits:
            nd = bit_diff(torch, got, want)
            bits[name][0] += nd
            bits[name][1] += got.numel()
            extra = f", {nd} of {got.numel()} lanes differ bitwise"
        print(f"  {name:22s} {what:42s} max_abs_err={err:.3e} {tol}{extra}")
        check(ok, f"{name} {what}: kernel and plain version disagree ({err}, {tol})")
        errs[name] = max(errs[name], err)

    def control(name, bad, want, what, **kw):
        ok, err, _ = agree(torch, bad, want, **kw)
        print(f"  {name:22s} control, {what}: fails the check (max_abs_err={err:.3e})")
        check(not ok, f"{name}: the check lets a faulty output pass ({what})")

    def update_case(x, mom, salts, ctr, nv, bf, cw, momentum, B, acc, what):
        """zo_reconstruct_update on copies of x (and mom) at x's alignment
        against its plain version: p outside and inside bf16 blocks, mom."""
        bfe = (bf != 0).repeat_interleave(B)
        p_k = cu._aligned_like(x).copy_(x)
        m_k = None if mom is None else cu._aligned_like(x).copy_(mom)
        cu.zo_reconstruct_update(p_k, m_k, salts, ctr, nv, bf, cw, lr, momentum, B, acc)
        p_r, m_r = ref.ref_zo_reconstruct_update(x, mom, salts, ctr, nv, bf, cw, lr, momentum,
                                                 B, acc)
        compare("zo_reconstruct_update", p_k[~bfe], p_r[~bfe], what + " p", base=x[~bfe])
        if bool(bfe.any()):
            compare("zo_reconstruct_update", p_k[bfe], p_r[bfe], what + " p, bf16 blocks",
                    bf16=True)
        if mom is not None:
            compare("zo_reconstruct_update", m_k, m_r, what + " mom", base=mom)
        return p_r

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
        stale = ref.ref_zo_perturb_sumsq(x, eng.blk_salts(t, 2), ctr, nv, 1e-3, B)[0]
        control("zo_perturb_sumsq", stale, want, f"{lname} another worker's v (stale)", base=x)
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
                p_r = update_case(x, mom, sm, ctr, nv, bf, coeffs, momentum, B, acc,
                                     f"{lname} acc={acc} momentum={momentum}")
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
                if momentum == 0.0 and acc == "float32":
                    p_sw, _ = ref.ref_zo_reconstruct_update(
                        x, None, sm, ctr, nv, bf, coeffs[[1, 0, 2, 3]], lr, 0.0, B, acc)
                    control("zo_reconstruct_update", p_sw[~bfe], p_r[~bfe],
                            f"{lname} workers 0 and 1's coefficients swapped", base=x[~bfe])
        if lname == "ragged":                         # every other m the kernel takes
            for m_ in (k for k in edge_ms if k != m):
                for acc in ("float32", "bfloat16"):
                    for momentum in (0.0, 0.9):
                        mom = None if momentum == 0.0 else torch.full_like(x, 0.1)
                        update_case(x, mom, eng.blk_salts_multi(t, range(m_)), ctr, nv, bf,
                                    coeffs8[:m_], momentum, B, acc,
                                    f"{lname} m={m_} acc={acc} momentum={momentum}")
    # zo_perturb_sumsq at a block that is not a multiple of 4, in a buffer that
    # starts off a 16-byte boundary, and past the L2 (4096 blocks of 4096)
    nbig, bbig = big
    for what, sizes_, blk, shift in (("block=257", [1000, 261, 1, 5], 257, 0),
                                     ("block=257, x at +4 bytes", [1000, 261, 1, 5], 257, 1),
                                     (f"{nbig} blocks of {bbig}", [nbig * bbig - 5], bbig, 0),
                                     (f"{nbig} blocks of {bbig}, x at +12 bytes",
                                      [nbig * bbig - 5], bbig, 3)):
        tree = {f"l{i}": torch.randn(n, generator=g).to(dev) for i, n in enumerate(sizes_)}
        eng = FlatEngine(tree, seed=0, block=blk)
        x = torch.cat([torch.zeros(shift, device=dev), eng.pack(tree)])[shift:]
        s1, ctr, nv = eng.blk_salts(t, 1), eng._blk_ctr, eng._blk_nv
        out, ss = cu.zo_perturb_sumsq(x, s1, ctr, nv, 1e-3, blk)
        want, wss = ref.ref_zo_perturb_sumsq(x, s1, ctr, nv, 1e-3, blk)
        compare("zo_perturb_sumsq", out, want, what, base=x)
        rel = float((ss / wss - 1.0).abs().max())
        out2, ss2 = cu.zo_perturb_sumsq(x, s1, ctr, nv, 1e-3, blk)
        print(f"  {'zo_perturb_sumsq':22s} {what + ' sumsq':42s} relative error {rel:.3e} "
              f"(tol 1e-5), the same run to run: {torch.equal(out, out2) and torch.equal(ss, ss2)}")
        check(rel <= 1e-5 and torch.equal(out, out2) and torch.equal(ss, ss2),
              f"zo_perturb_sumsq {what}: sumsq off by {rel} or not the same run to run")
        sumsq_rel = max(sumsq_rel, rel)
        if blk == 257:                                # the vector kernels too
            compare("zo_perturb_flat", cu.zo_perturb_flat(x, s1, ctr, nv, 1e-2, blk),
                    ref.ref_zo_perturb_flat(x, s1, ctr, nv, 1e-2, blk), what, base=x)
            smb = eng.blk_salts_multi(t, range(m))
            update_case(x, None, smb, ctr, nv, eng._blk_bf16, coeffs, 0.0, blk, "float32", what)
            for acc in ("float32", "bfloat16"):
                compare("zo_reconstruct_flat", cu.zo_reconstruct_flat(smb, coeffs, ctr, nv, blk, acc),
                        ref.ref_zo_reconstruct_flat(smb, coeffs, ctr, nv, blk, acc),
                        f"{what} acc={acc}", bf16=acc == "bfloat16")

    # both redesigned kernels at a block of 257 on a buffer past one lane per
    # thread of the whole card, so they take 16-byte vectors and some cross a
    # block's edge: random salts, counters (wrapping) and valid lanes per
    # block, one block in 8 bf16, at a 16-byte boundary and 4 bytes past one
    rng = np.random.default_rng(5)
    eb, nbe = 257, edge_blocks
    ne = eb * nbe
    nv_e = torch.from_numpy(np.where(rng.random(nbe) < 0.75, eb, rng.integers(1, eb + 1, nbe))
                            .astype(np.int32)).to(dev)
    ctr_e = torch.from_numpy(rng.integers(0, 2 ** 32, nbe, dtype=np.uint64)
                             .astype(np.uint32)).to(dev)
    salts_e = torch.from_numpy(rng.integers(0, 2 ** 32, (nbe, max(edge_ms)), dtype=np.uint64)
                               .astype(np.uint32)).to(dev)
    bf_e = torch.from_numpy((rng.random(nbe) < 0.125).astype(np.int32)).to(dev)
    x0 = torch.randn(ne, generator=g).to(dev)
    for shift in (0, 1):
        x = torch.cat([torch.zeros(shift, device=dev), x0])[shift:]
        where = f"block=257 x{nbe}" + (f", x at +{4 * shift} bytes" if shift else "")
        s1 = salts_e[:, 0].contiguous()
        compare("zo_perturb_flat", cu.zo_perturb_flat(x, s1, ctr_e, nv_e, 1e-2, eb),
                ref.ref_zo_perturb_flat(x, s1, ctr_e, nv_e, 1e-2, eb), where, base=x)
        for m_ in edge_ms:
            for acc in ("float32", "bfloat16"):
                for momentum in (0.0, 0.9):
                    mom = None if momentum == 0.0 else torch.full_like(x, 0.1)
                    update_case(x, mom, salts_e[:, :m_].contiguous(), ctr_e, nv_e, bf_e,
                                coeffs8[:m_], momentum, eb, acc,
                                f"{where} m={m_} acc={acc} momentum={momentum}")
    for m_ in edge_ms:                          # its output is a fresh, aligned buffer
        for acc in ("float32", "bfloat16"):
            se = salts_e[:, :m_].contiguous()
            compare("zo_reconstruct_flat", cu.zo_reconstruct_flat(se, coeffs8[:m_], ctr_e, nv_e,
                                                                  eb, acc),
                    ref.ref_zo_reconstruct_flat(se, coeffs8[:m_], ctr_e, nv_e, eb, acc),
                    f"block=257 x{nbe} m={m_} acc={acc}", bf16=acc == "bfloat16")
    # controls at shift 0 (head 0): the next block's salts across a vector's edge
    ls, lc, lv, lb = per_lane(torch, salts_e[:, :m], ctr_e, nv_e, bf_e, eb, ne)
    bad_s, crossing = edge_fault(torch, ls, salts_e[:, :m], eb, 0, ne)
    want = ref.ref_zo_perturb_flat(x0, s1, ctr_e, nv_e, 1e-2, eb)
    check(torch.equal(ref.ref_zo_perturb_flat(x0, ls[:, 0].contiguous(), lc, lv, 1e-2, 1), want),
          "the per-lane layout does not give the plain version's output")
    control("zo_perturb_flat", ref.ref_zo_perturb_flat(x0, bad_s[:, 0].contiguous(), lc, lv,
                                                       1e-2, 1), want,
            f"block=257 the next block's salt across {crossing} vectors' edges", base=x0)
    sm_e = salts_e[:, :m].contiguous()
    want, _ = ref.ref_zo_reconstruct_update(x0, None, sm_e, ctr_e, nv_e, bf_e, coeffs, lr, 0.0,
                                            eb, "float32")
    keep = ~(bf_e != 0).repeat_interleave(eb)
    bad, _ = ref.ref_zo_reconstruct_update(x0, None, bad_s, lc, lv, lb, coeffs, lr, 0.0, 1,
                                           "float32")
    control("zo_reconstruct_update", bad[keep], want[keep],
            f"block=257 the next block's salts across {crossing} vectors' edges", base=x0[keep])
    control("zo_reconstruct_flat", ref.ref_zo_reconstruct_flat(bad_s, coeffs, lc, lv, 1),
            ref.ref_zo_reconstruct_flat(sm_e, coeffs, ctr_e, nv_e, eb),
            f"block=257 the next block's salts across {crossing} vectors' edges")
    # zo_perturb_flat into a caller's buffer off a 16-byte boundary, x at the
    # same alignment (vectors between a scalar head and tail) or another one
    # (scalar lanes only): canaries of 256 values around it stay untouched
    scale_t = torch.tensor(1e-2, device=dev)
    want = ref.ref_zo_perturb_flat(x0, s1, ctr_e, nv_e, 1e-2, eb)
    for xs, at in ((1, 1), (3, 3), (0, 1)):
        x = torch.cat([torch.zeros(xs, device=dev), x0])[xs:]
        buf = torch.full((ne + at + 256,), 7.0, device=dev)
        flat_perturb_into(torch, x, s1, ctr_e, nv_e, scale_t, buf[at:], eb)
        torch.cuda.synchronize()
        compare("zo_perturb_flat", buf[at:at + ne], want,
                f"x at +{4 * xs} bytes into a buffer at +{4 * at}", base=x0)
        ok = bool((buf[:at] == 7.0).all()) and bool((buf[at + ne:] == 7.0).all())
        print(f"  {'zo_perturb_flat':22s} the canaries around that buffer untouched: {ok}")
        check(ok, "zo_perturb_flat wrote past its output")
    for name, (nd, lanes) in bits.items():
        print(f"  {name:22s} {nd} of {lanes} output lanes differ bitwise from the plain "
              f"version over every case above (must be 0)")
        check(nd == 0, f"{name}: {nd} lanes differ bitwise from the plain version")
    torch.cuda.synchronize()

    # times at the Fig. 2 shape, main-path configuration (fp32 acc, no momentum)
    eng = layouts["fig2"]
    x = eng.pack(fig2_params)
    s1, sm = eng.blk_salts(t, 1), eng.blk_salts_multi(t, range(m))
    ctr, nv, bf, B = eng._blk_ctr, eng._blk_nv, eng._blk_bf16, eng.block
    P, nb, d = eng.padded_dim, eng.n_blocks, eng.dim
    p_work = x.clone()
    meta = nb * 12                       # salts, counters, valid lanes
    # instructions: one Gaussian per valid lane and worker
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
            2 * P * 4 + nb * (8 + 4 * m) + 4 * m, d * m * gauss_instr),
        "zo_perturb_flat": (        # FlatEngine.perturb's scale is a tensor on the card
            lambda: cu.zo_perturb_flat(x, s1, ctr, nv, scale_t, B),
            lambda: ref.ref_zo_perturb_flat(x, s1, ctr, nv, scale_t, B),
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
                      "bound_ms": b, "bound_by": by, "max_abs_err": errs[name],
                      "gauss_instructions": gauss_instr}
        if name in bits:
            rows[name]["bitwise_diff_lanes"], rows[name]["lanes_compared"] = bits[name]
        rows[name]["stream_ms"] = stream_ms(torch, kern)
        if name == "zo_perturb_sumsq":
            rows[name]["sumsq_rel_err"] = sumsq_rel
            rows[name]["floor_ms"] = floor_ms(torch, dev)
            mu_fill = lambda: torch.full((1,), 1e-3, device=dev)      # noqa: E731
            rows[name]["mu_fill_stream_ms"] = stream_ms(torch, mu_fill)
            rows[name]["launches_per_call"] = cu.LAUNCHES_PER_CALL[name]
            rows[name]["launch_stream_ms"] = sumsq_launches_ms(torch, cu, x, s1, ctr, nv, B)
            print(f"  {name:22s} back to back: {rows[name]['stream_ms']:.5f} ms per call, its "
                  f"launches apart {rows[name]['launch_stream_ms'][0]:.5f} (Gaussians, v and "
                  f"partial sums) and {rows[name]['launch_stream_ms'][1]:.5f} (the sum and the "
                  f"stream of x and v); the per-call floor (a one-value fill by the same "
                  f"timing): {rows[name]['floor_ms']:.5f} ms; the fill of mu that the "
                  f"binding no longer runs, back to back: "
                  f"{rows[name]['mu_fill_stream_ms']:.5f} ms")
        if name == "zo_reconstruct_update":
            lr_fill = lambda: torch.full((1,), lr, device=dev)        # noqa: E731
            rows[name]["lr_fill_stream_ms"] = stream_ms(torch, lr_fill)
            print(f"  {name:22s} back to back: {rows[name]['stream_ms']:.5f} ms per call; the "
                  f"fill of lr that the binding no longer runs, back to back: "
                  f"{rows[name]['lr_fill_stream_ms']:.5f} ms")
        if name == "zo_perturb_flat":
            # and with a host scale, which the binding writes to the card
            # with a fill kernel per call (the earlier timing's call)
            rows[name]["host_scale_ms"] = cuda_ms(torch, lambda: cu.zo_perturb_flat(
                x, s1, ctr, nv, 1e-2, B))
            print(f"  {name:22s} back to back: {rows[name]['stream_ms']:.5f} ms per call; one "
                  f"call with a host scale (a fill kernel first): "
                  f"{rows[name]['host_scale_ms']:.4f} ms")
        if name == "zo_reconstruct_flat":
            print(f"  {name:22s} back to back: {rows[name]['stream_ms']:.5f} ms per call")
        print(f"  {name:22s} ms={rows[name]['ms']:.4f} plain_ms="
              f"{rows[name]['plain_ms']:.4f} bound_ms={b:.4f} ({by}; bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}, instructions "
              f"{ninstr / INSTR_PER_S * 1e3:.4f}) library_ms=none (no PyTorch "
              f"call computes the hashed Gaussian)")
    if m_variant_lib is not None:
        for name, ab in unrolled_m_ab(torch, m_variant_lib, x, sm, ctr, nv, bf, coeffs, lr,
                                      B).items():
            rows[name]["unrolled_m_ab"] = ab
    return rows


# --------------------------------------------------------------------------- #
# phases 4-6: the training paths
# --------------------------------------------------------------------------- #
def fig2_phase(torch, dev, hidden=1300):
    from repro_torch.apps.classification import run_comparison
    from repro_torch.kernels import ops
    from repro_torch.kernels import zo_direction as cu

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
    per_call = cu.LAUNCHES_PER_CALL["zo_perturb_sumsq"]
    check(launches["zo_perturb_sumsq"] == per_call * 4 * n_zo,
          f"zo_perturb_sumsq launched {launches['zo_perturb_sumsq']} times, expected "
          f"{per_call} per call, one call per worker per ZO step = {per_call * 4 * n_zo}")
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


def profile_phase(torch, dev, hidden=1300, engine="flat"):
    """Where a ZO step's time goes with ``engine``: torch.profiler over 7 ZO
    steps (t=9..15) after 7 warm-up ZO steps; device busy time by kernel and
    the device's idle share of the host's wall time."""
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
                                             zo_lr=0.05 * 30.0 / d, engine=engine))
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
    print(f"  {n} ZO steps (engine={engine}): host wall {1e3 * wall / n:.3f} ms/step")
    if not rows:
        print("  device busy time and idle share: not measured (the profiler saw "
              "no device time)")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3
    fills = sum(r[1] for r in rows if "Fill" in r[2]) / n
    print(f"  device busy {busy_ms / n:.3f} ms/step, device idle share "
          f"{1.0 - busy_ms / (1e3 * wall):.3f}, {sum(r[1] for r in rows) / n:.0f} device "
          f"kernels and copies per step, {fills:.0f} of them fills")
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
# phase 7: the per-leaf kernels against their plain versions
# --------------------------------------------------------------------------- #
def perturb_into(torch, x, out, salt, scale, offset):
    """Launch zo_perturb's float32 kernel writing into ``out`` (a caller's
    buffer, longer than the leaf): the canary check's way in."""
    from repro_torch.kernels import zo_direction as cu

    dev = x.device
    cu._launch("zo_perturb", "zo_perturb_leaf_launch", x.data_ptr(), out.data_ptr(),
               x.numel(), salt, offset, scale.reshape(1).data_ptr(), 0, dev.index,
               torch.cuda.current_stream(dev).cuda_stream)


def leaf_kernel_phase(torch, dev, gauss_instr, uniform_instr,
                      sizes=FIG2_LEAVES + RAGGED_LEAVES, timed_sizes=FIG2_LEAVES):
    from repro_torch.kernels import ref
    from repro_torch.kernels import zo_direction as cu

    g = torch.Generator().manual_seed(13)
    salt, off1, k_split = 0x2545F491, 12345, 1234567
    wrap = 2 ** 32 - 1000            # zo_sumsq's counters wrap inside a leaf past 1000 values
    scale = torch.tensor(0.37, device=dev)    # an O(1) perturbation: every bit shows
    salts = torch.tensor([101, 202, 303, 404], dtype=torch.int64).to(torch.uint32)
    coeffs = torch.tensor([0.5, -1.0, 2.0, 0.1], device=dev)
    errs = {k: 0.0 for k in LEAF_REPLACES}
    sumsq_rel = 0.0

    def same(name, got, want, what, bf16=False):
        if bf16:
            ok, err, tol = agree(torch, got, want, bf16=True)
        else:
            ok, err, tol = torch.equal(got, want), float((got - want).abs().max()), "bitwise"
        print(f"  {name:15s} {what:50s} max_abs_err={err:.3e} ({tol})")
        check(ok, f"{name} {what}: kernel and plain version disagree ({err}, {tol})")
        errs[name] = max(errs[name], err)

    def control(name, ok, what, err):
        print(f"  {name:15s} control, {what}: fails the check (error {err:.3e})")
        check(not ok, f"{name}: the check lets a faulty output pass ({what})")

    def sumsq_check(n, off):
        nonlocal sumsq_rel
        got = cu.zo_sumsq(n, salt, off, dev)
        want = ref.ref_zo_sumsq(n, salt, off, device=dev)
        rel = float(abs(got / want - 1.0))
        print(f"  {'zo_sumsq':15s} {f'n={n} offset={off}':50s} relative error {rel:.3e} "
              f"(tol 1e-6)")
        check(rel <= 1e-6, f"zo_sumsq n={n} offset={off}: relative error {rel}")
        check(torch.equal(got, cu.zo_sumsq(n, salt, off, dev)),
              "zo_sumsq is not the same run to run")
        sumsq_rel = max(sumsq_rel, rel)
        errs["zo_sumsq"] = max(errs["zo_sumsq"], float(abs(got - want)))

    # zo_perturb on views off a 16-byte boundary (x[1:], x[3:]): small leaves
    # take the scalar lanes, the w2 size the vectors with a scalar head and tail
    for n in (1, 3, 5, 4097, 70201, max(sizes) + 1):
        base = torch.randn(n + 3, generator=g).to(dev)
        for k in (1, 3):
            x, xb = base[k:k + n], base.to(torch.bfloat16)[k:k + n]
            what = f"n={n} view x[{k}:] (+{4 * k} bytes)"
            same("zo_perturb", cu.zo_perturb(x, salt, scale, off1),
                 ref.ref_zo_perturb(x, salt, scale, off1), what + " float32")
            same("zo_perturb", cu.zo_perturb(xb, salt, scale, off1),
                 ref.ref_zo_perturb(xb, salt, scale, off1), what + " bfloat16", bf16=True)

    for n in sizes:
        x = torch.randn(n, generator=g).to(dev)
        for off in (0, off1):
            what = f"n={n} offset={off}"
            same("zo_perturb", cu.zo_perturb(x, salt, scale, off),
                 ref.ref_zo_perturb(x, salt, scale, off), what + " float32")
            xb = x.to(torch.bfloat16)
            same("zo_perturb", cu.zo_perturb(xb, salt, scale, off),
                 ref.ref_zo_perturb(xb, salt, scale, off), what + " bfloat16", bf16=True)
            for m in (1, 4):
                s = salts[:m]
                for acc in ("float32", "bfloat16"):
                    same("zo_reconstruct", cu.zo_reconstruct(n, s.to(dev), coeffs[:m], off, acc),
                         ref.ref_zo_reconstruct(n, s, coeffs[:m], off, acc, device=dev),
                         f"{what} m={m} acc={acc}", bf16=acc == "bfloat16")
            sumsq_check(n, off)
        sumsq_check(n, wrap)

    # the split leaf: two calls at offsets 0 and k equal one call
    n = max(sizes)
    k = min(k_split, n // 2)
    x = torch.randn(n, generator=g).to(dev)
    s4 = salts.to(dev)
    check(torch.equal(torch.cat([cu.zo_perturb(x[:k], salt, scale, 0),
                                 cu.zo_perturb(x[k:], salt, scale, k)]),
                      cu.zo_perturb(x, salt, scale, 0)), "zo_perturb: split leaf differs")
    check(torch.equal(torch.cat([cu.zo_reconstruct(k, s4, coeffs, 0),
                                 cu.zo_reconstruct(n - k, s4, coeffs, k)]),
                      cu.zo_reconstruct(n, s4, coeffs, 0)), "zo_reconstruct: split leaf differs")
    rels = []
    for off in (0, wrap):                   # at `wrap` the counter wraps in the first part
        parts = cu.zo_sumsq(k, salt, off, dev) + cu.zo_sumsq(n - k, salt, (off + k) % 2 ** 32, dev)
        rels.append(float(abs(parts / cu.zo_sumsq(n, salt, off, dev) - 1.0)))
        check(rels[-1] <= 1e-6, f"zo_sumsq: split leaf at offset {off} differs by {rels[-1]}")
    print(f"  split leaf n={n} at k={k}: zo_perturb and zo_reconstruct bitwise equal to "
          f"one call, zo_sumsq within {rels[0]:.2e} (offset 0) and {rels[1]:.2e} (offset "
          f"{wrap})")

    # controls: each check above must reject these faulty outputs
    n = 5000                                           # a ragged tail
    x = torch.randn(n, generator=g).to(dev)
    lanes = -(-n // 256) * 256                          # what unmasked 256-thread blocks take
    want = ref.ref_zo_sumsq(n, salt, 0, device=dev)
    bad = ref.ref_zo_sumsq(lanes, salt, 0, device=dev)
    control("zo_sumsq", float(abs(bad / want - 1.0)) <= 1e-6,
            f"tail mask dropped ({lanes - n} lanes past n={n})", float(abs(bad / want - 1.0)))
    canary = lambda b, n: bool((b[n:] == 7.0).all())        # noqa: E731
    for nc in (max(sizes) + 3, n):           # the vector lanes' ragged tail; scalar lanes only
        xc = torch.randn(nc, generator=g).to(dev)
        buf = torch.full((nc + 256,), 7.0, device=dev)
        perturb_into(torch, xc, buf, salt, scale, 0)
        torch.cuda.synchronize()
        check(canary(buf, nc) and torch.equal(buf[:nc], ref.ref_zo_perturb(xc, salt, scale, 0)),
              "zo_perturb wrote past the leaf or wrote wrong values")
        print(f"  {'zo_perturb':15s} canary of 256 values after the leaf (n={nc}) untouched")
    bad = buf.clone()
    x_up = torch.cat([x, torch.zeros(lanes - n, device=dev)])
    bad[:lanes] = ref.ref_zo_perturb(x_up, salt, scale, 0)
    control("zo_perturb", canary(bad, n), f"stores past n ({lanes - n} lanes into the canary)",
            float((bad[n:] - 7.0).abs().max()))
    for name, got, want in (
            ("zo_perturb", ref.ref_zo_perturb(x, salt, scale, 0),
             ref.ref_zo_perturb(x, salt, scale, off1)),
            ("zo_reconstruct", ref.ref_zo_reconstruct(n, salts, coeffs, 0, device=dev),
             ref.ref_zo_reconstruct(n, salts, coeffs, off1, device=dev))):
        control(name, torch.equal(got, want), f"offset {off1} ignored",
                float((got - want).abs().max()))
    n = max(sizes)
    want = ref.ref_zo_reconstruct(n, salts, coeffs, 0, "bfloat16", device=dev)
    bad = ref.ref_zo_reconstruct(n, salts, coeffs, 0, "float32", device=dev)
    control("zo_reconstruct", agree(torch, bad, want, bf16=True)[0],
            f"float32 accumulator where bfloat16 was asked (n={n}, m=4)",
            float((bad - want).abs().max()))
    torch.cuda.synchronize()

    # times at the w2 leaf, the main path's largest launch (float32, m=4)
    x = torch.randn(n, generator=g).to(dev)
    m = 4
    runs = {
        "zo_perturb": (lambda: cu.zo_perturb(x, salt, scale, 0),
                       lambda: ref.ref_zo_perturb(x, salt, scale, 0),
                       8 * n + 4, n * gauss_instr),
        "zo_reconstruct": (lambda: cu.zo_reconstruct(n, s4, coeffs, 0),
                           lambda: ref.ref_zo_reconstruct(n, salts, coeffs, 0, device=dev),
                           4 * n + 8 * m, m * n * gauss_instr),
        "zo_sumsq": (lambda: cu.zo_sumsq(n, salt, 0, dev),
                     lambda: ref.ref_zo_sumsq(n, salt, 0, device=dev),
                     4, n * gauss_instr),
    }
    rows = {}
    for name, (kern, plain, nbytes, ninstr) in runs.items():
        p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kern, kern, plain))
        b, by = bound_ms(nbytes, ninstr)
        rows[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": b,
                      "bound_by": by, "max_abs_err": errs[name], "n": n,
                      "gauss_instructions": gauss_instr}
        if name == "zo_sumsq":
            rows[name]["sumsq_rel_err"] = sumsq_rel
            rows[name]["launches_per_call"] = cu.LAUNCHES_PER_CALL[name]
            rows[name]["stream_ms"] = stream_ms(torch, kern)
            rows[name]["launch_stream_ms"] = leaf_sumsq_launches_ms(torch, cu, n, salt, dev)
            print(f"  {name:15s} n={n} back to back: {rows[name]['stream_ms']:.5f} ms per call, "
                  f"its launches apart {rows[name]['launch_stream_ms'][0]:.5f} (the Gaussians "
                  f"and partial sums) and {rows[name]['launch_stream_ms'][1]:.5f} (the sum of "
                  f"the partials)")
        print(f"  {name:15s} n={n}: ms={rows[name]['ms']:.4f} plain_ms="
              f"{rows[name]['plain_ms']:.4f} bound_ms={b:.4f} ({by}; bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}, instructions "
              f"{ninstr / INSTR_PER_S * 1e3:.4f}) library_ms=none")
    # zo_perturb at each of the MLP's leaf sizes (each launched m times per ZO
    # step), and at w2 back to back
    by_size = []
    for nl in sorted(set(timed_sizes)):
        xl = torch.randn(nl, generator=g).to(dev)
        kern = lambda: cu.zo_perturb(xl, salt, scale, 0)            # noqa: E731
        plain = lambda: ref.ref_zo_perturb(xl, salt, scale, 0)      # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kern, kern, plain))
        b, by = bound_ms(8 * nl + 4, nl * gauss_instr)
        by_size.append({"n": nl, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                        "bound_ms": b, "bound_by": by})
        print(f"  {'zo_perturb':15s} n={nl}: ms={(k1 + k2) / 2:.5f} plain_ms="
              f"{(p1 + p2) / 2:.5f} bound_ms={b:.5f} ({by})")
    rows["zo_perturb"]["by_size"] = by_size
    rows["zo_perturb"]["stream_ms"] = stream_ms(torch, runs["zo_perturb"][0])
    rows["zo_perturb"]["floor_ms"] = floor_ms(torch, dev)
    # what holds it back: the same loop and grid with no load or store, with
    # the whole Gaussian and with its hash and uniforms alone, back to back
    # (the Gaussian probes of the build phase take the parts apart)
    full = rows["zo_perturb"]["stream_ms"]
    compute, hashed = (stream_ms(torch, lambda part=part: cu.probe_part(n, part, 4, dev))
                       for part in ("gauss", "uniforms"))
    rest = gauss_instr - uniform_instr
    issue = n * rest / INSTR_PER_S * 1e3
    print(f"  {'zo_perturb':15s} n={n} back to back: {full:.5f} ms with its loads and stores, "
          f"{compute:.5f} without them, {hashed:.5f} with only the hash and uniforms "
          f"({uniform_instr} of the Gaussian's {gauss_instr} instructions); the other {rest} "
          f"instructions a lane take {compute - hashed:.5f} ms (their issue time "
          f"{issue:.5f}); the per-call floor {rows['zo_perturb']['floor_ms']:.5f} ms")
    rows["zo_perturb"]["compute_only_ms"] = compute
    rows["zo_perturb"]["uniforms_only_ms"] = hashed
    return rows


# --------------------------------------------------------------------------- #
# phase 8: the Fig. 2 method set through engine="pallas"
# --------------------------------------------------------------------------- #
def ledger_run(torch, meth, params, data, n_iters, key=0):
    """``meth`` for ``n_iters`` steps, each wrapped in a CommLedger under its
    round's tag; returns (losses, comm_bytes per step, the ledger)."""
    from repro_torch.dist import CommLedger

    prog, ledger, wrapped = meth.program, CommLedger(), {}
    state, losses, nbytes = meth.init(params), [], []
    for t in range(n_iters):
        tag = prog.round_for(t, state).round.tag
        step = wrapped.setdefault(tag, ledger.wrap(tag, meth.step))
        params, state, met = step(t, params, state, next(data), key)
        losses.append(float(met["loss"]))
        nbytes.append(met["comm_bytes"])
    return losses, nbytes, ledger


def method_set_phase(torch, dev, hidden=1300, n_iters=32, small_hidden=64):
    import numpy as np

    from repro_torch.apps.classification import load_dataset, run_comparison
    from repro_torch.core import HOSGDConfig, make_ho_sgd, to_method
    from repro_torch.core.baselines import make_pa_sgd, make_qsgd, make_ri_sgd
    from repro_torch.core.engine import make_engine
    from repro_torch.core.rounds import ho_sgd_program
    from repro_torch.data.synthetic import batches
    from repro_torch.dist.compress import qsgd
    from repro_torch.kernels import ops
    from repro_torch.kernels import zo_direction as cu
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss

    m, B, tau, lr, mu, seed = 4, 64, 8, 0.05, 1e-3, 0
    kw = dict(n_iters=n_iters, m=m, B=B, tau=tau, hidden=hidden, lr=lr, mu=mu, seed=seed,
              eval_every=n_iters)
    ops.reset_launch_counts()
    res = run_comparison("covtype", engine="pallas", methods=METHODS, device=dev, **kw)
    torch.cuda.synchronize()
    # zo_sumsq on every leaf of the trained tree for one (t, worker), against
    # the engine's shared plain reduction
    params = res["ho_sgd"]["params"]
    eng = make_engine("pallas", params, seed)
    t_s, w_s = 9, 2
    parts = [ops.zo_sumsq(n, s, device=dev) for n, s in zip(eng.sizes, eng.salts(t_s, w_s))]
    total, plain = float(torch.stack(parts).sum()), float(eng.sumsq(t_s, w_s))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"  launches (7 methods, {n_iters} steps each, engine=pallas): {launches}")
    rel = abs(total / plain - 1.0)
    print(f"  zo_sumsq over the {len(parts)} leaves at (t={t_s}, worker={w_s}): {total:.6f} vs "
          f"engine.sumsq {plain:.6f}, relative {rel:.3e} (tol 1e-5)")
    check(rel <= 1e-5, f"zo_sumsq over the leaves differs from engine.sumsq by {rel}")

    d = sum(eng.sizes)
    n_leaves = len(eng.sizes)
    ho = res["ho_sgd"]
    order = [1 if t % tau == 0 else 0 for t in range(n_iters)]
    n_zo = order.count(0)
    check(ho["order"] == order, f"unexpected HO-SGD order {ho['order']}")
    want = {"zo_perturb": n_leaves * m * n_zo, "zo_reconstruct": n_leaves * n_zo,
            "zo_sumsq": cu.LAUNCHES_PER_CALL["zo_sumsq"] * n_leaves}
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times, expected {n}")
    others = {k: v for k, v in launches.items() if k not in want}
    check(not any(others.values()), f"kernels off the pallas path launched: {others}")
    print(f"  HO-SGD: {n_leaves} leaves x m={m} x {n_zo} ZO steps = {want['zo_perturb']} "
          f"zo_perturb, {n_leaves} x {n_zo} = {want['zo_reconstruct']} zo_reconstruct; "
          f"zo_sumsq {cu.LAUNCHES_PER_CALL['zo_sumsq']} launches x {n_leaves} leaves")

    for name in METHODS:
        h = res[name]
        check(all(math.isfinite(v) for v in h["loss"]), f"{name}: non-finite loss")
        first, tail = h["loss"][0], statistics.mean(h["loss"][-8:])
        if name in ("ho_sgd", "sync_sgd", "pa_sgd", "ri_sgd", "qsgd"):
            check(tail < first, f"{name}: mean of the last 8 losses {tail} not below the "
                  f"first {first}")
        fo = [s for s, o in zip(h["iter_s"][1:], h["order"][1:]) if o == 1]
        zo = [s for s, o in zip(h["iter_s"][1:], h["order"][1:]) if o == 0]
        times = "; ".join(f"{k} median {1e3 * statistics.median(v):.3f} ms (n={len(v)})"
                          for k, v in (("FO", fo), ("ZO", zo)) if v)
        print(f"  {name:11s} loss {first:.5f} -> last-8 mean {tail:.5f}; steps after the "
              f"first: {times}; final_acc {h['final_acc']:.4f}")

    # analytic meters (Table 1 per worker), against their closed forms
    analytic = {"ho_sgd": (d + tau - 1) / tau, "sync_sgd": float(d), "ri_sgd": d / tau,
                "pa_sgd": d / tau, "zo_sgd": 1.0, "zo_svrg_ave": 1.0,
                "qsgd": (8 * 8 + 8 * math.sqrt(d)) / 32.0}
    for name, per_iter in analytic.items():
        got = res[name]["meter"]["scalars_sent_per_worker"]
        check(math.isclose(got, per_iter * n_iters, rel_tol=1e-12),
              f"{name}: scalars_sent_per_worker {got} != {per_iter * n_iters}")
    print(f"  MeterRegistry scalars_sent_per_worker equal the analytic forms for all "
          f"{len(analytic)} methods")

    # HO-SGD: the kernels against the plain engine, and the round program
    fused = run_comparison("covtype", engine="fused", methods=["ho_sgd"], device=dev,
                           **kw)["ho_sgd"]
    check(fused["order"] == ho["order"], "pallas and fused FO/ZO orders differ")
    rel_f = max(abs(a - b) / abs(b) for a, b in zip(ho["loss"], fused["loss"]))
    print(f"  HO-SGD pallas vs fused: max relative loss difference {rel_f:.3e} (tol 1e-3)")
    check(rel_f <= 1e-3, f"HO-SGD pallas vs fused losses differ by {rel_f}")

    ds = load_dataset("covtype")
    p0 = init_mlp_classifier(torch.Generator().manual_seed(seed), ds.n_features,
                             ds.n_classes, hidden=hidden, device=dev)
    cfg = HOSGDConfig(tau=tau, mu=mu, m=m, lr=lr, zo_lr=lr * 30.0 / d, engine="pallas")
    d_leaves = [int(x.numel()) for x in (p0[k] for k in sorted(p0))]
    closed = {
        "ho_sgd_program": [4 * d if o else 4 * m for o in order],
        "pa_sgd": [4 * d if (t + 1) % tau == 0 else 0 for t in range(n_iters)],
        "ri_sgd": [4 * d if (t + 1) % tau == 0 else 0 for t in range(n_iters)],
        "qsgd": [m * sum(qsgd(8).nbytes(n) for n in d_leaves)] * n_iters,
    }
    methods = {
        "ho_sgd_program": lambda: to_method(ho_sgd_program(mlp_loss, cfg)),
        "pa_sgd": lambda: make_pa_sgd(mlp_loss, m, tau=tau, lr=lr),
        "ri_sgd": lambda: make_ri_sgd(mlp_loss, m, tau=tau, lr=lr, mu_r=0.25),
        "qsgd": lambda: make_qsgd(mlp_loss, m, s=8, lr=lr),
    }
    ledgers = {}
    for name, build in methods.items():
        losses, nbytes, ledger = ledger_run(torch, build(), p0,
                                            batches(ds, m * B, seed=seed + 1), n_iters, seed)
        ledgers[name] = ledger
        torch.cuda.synchronize()
        check(nbytes == closed[name], f"{name}: comm_bytes {nbytes[:9]} differ from the "
              f"closed form {closed[name][:9]}")
        check(ledger.total_bytes() == sum(nbytes), f"{name}: ledger books "
              f"{ledger.total_bytes()}, comm_bytes sum to {sum(nbytes)}")
        if name != "ho_sgd_program":
            check(res[name]["comm_bytes"] == nbytes,
                  f"{name}: run_comparison's comm_bytes differ from the ledger run's")
        per_round = {k: v["bytes_per_step"] for k, v in ledger.summary().items()}
        print(f"  {name:15s} comm_bytes per round {per_round}, ledger total "
              f"{ledger.total_bytes()} B in {n_iters} steps = closed form")
        if name == "ho_sgd_program":
            rel_p = max(abs(a - b) / abs(b) for a, b in zip(losses, ho["loss"]))
            print(f"  HO-SGD round program vs make_ho_sgd (both pallas): max relative loss "
                  f"difference {rel_p:.3e} (tol 1e-3)")
            check(rel_p <= 1e-3, f"HO-SGD round program vs make_ho_sgd differ by {rel_p}")
    ho_ledger = ledgers["ho_sgd_program"]
    check(ho_ledger.bytes_per_step("zo") == 4 * m and ho_ledger.bytes_per_step("fo") == 4 * d,
          "HO-SGD ledger: not 4m per ZO round and 4d per FO round")

    # port against port at small width: the card's run against the CPU's
    small = dict(kw, hidden=small_hidden, n_iters=8, eval_every=8)
    held = [n for n in METHODS if n != "qsgd"]
    gpu = run_comparison("covtype", engine="pallas", methods=held, device=dev, **small)
    cpu = run_comparison("covtype", engine="pallas", methods=held, device="cpu", **small)
    for name in held:
        r = max(abs(a - b) / abs(b) for a, b in zip(gpu[name]["loss"], cpu[name]["loss"]))
        print(f"  hidden={small_hidden} {name:11s}: card vs CPU max relative loss difference "
              f"{r:.3e} (tol 1e-3)")
        check(r <= 1e-3 and gpu[name]["order"] == cpu[name]["order"],
              f"{name}: card and CPU runs differ")
    print("  qsgd is not held card against CPU: its uniforms come from a generator on the "
          "gradient's device (CUDA Philox on the card, CPU Mersenne Twister on the CPU)")
    return launches


# --------------------------------------------------------------------------- #
# phases 8b and 8c: federated partial participation; HO-SGD over a process group
# --------------------------------------------------------------------------- #
def fig2_setup(torch, dev, hidden):
    """The Fig. 2 model's initial parameters on ``dev`` (seed 0) and the
    covtype stand-in."""
    from repro_torch.apps.classification import load_dataset
    from repro_torch.models.mlp import init_mlp_classifier

    ds = load_dataset("covtype")
    p0 = init_mlp_classifier(torch.Generator().manual_seed(0), ds.n_features, ds.n_classes,
                             hidden=hidden, device=dev)
    return ds, p0, sum(int(p.numel()) for p in p0.values())


def round_times(times, orders, order):
    """Median ms of the rounds of ``order`` after the first round."""
    sel = [1e3 * s for s, o in zip(times[1:], orders[1:]) if o == order]
    return statistics.median(sel) if sel else float("nan")


def federated_phase(torch, dev, hidden=1300, rounds=16, fedavg_rounds=4):
    """Fed-HO-SGD (K=4 of N=1000 clients, availability 0.75, tau=8) through
    ``RoundExecutor`` with engine flat, pallas and tree, then FedAvg: the
    kernels' runs against tree's losses, the bytes of every round against
    the live cohort, launch counts per run and ms per round."""
    from repro_torch.core import HOSGDConfig
    from repro_torch.core.federated import ClientSampling, fed_avg_program
    from repro_torch.core.rounds import RoundExecutor, ho_sgd_program
    from repro_torch.data.synthetic import batches
    from repro_torch.dist import CommLedger
    from repro_torch.kernels import ops
    from repro_torch.models.mlp import mlp_loss

    ds, p0, d = fig2_setup(torch, dev, hidden)
    m, B, tau, lr, mu = 4, 64, 8, 0.05, 1e-3
    cs = ClientSampling(n_clients=1000, cohort_k=m, seed=0, availability=0.75)
    data = [b for _, b in zip(range(rounds), batches(ds, m * B, seed=1))]
    live = [len(cs.cohort_for(t)) for t in range(rounds)]
    check(min(live) < m, f"availability 0.75 left every cohort whole: {live}")
    n_leaves = len(p0)

    def run(prog, n):
        ex, ledger, wrapped = RoundExecutor(prog), CommLedger(), {}
        params, state = p0, prog.init(p0)
        hist = {"loss": [], "order": [], "s": []}
        ops.reset_launch_counts()
        for t in range(n):
            tag = prog.round_for(t, state).round.tag
            step = wrapped.setdefault(tag, ledger.wrap(tag, ex.run))
            ts = time.perf_counter()
            params, state, met = step(t, params, state, data[t])
            hist["loss"].append(float(met["loss"]))          # waits for the card
            hist["s"].append(time.perf_counter() - ts)
            hist["order"].append(met["order"])
            want = 4 * live[t] if met["order"] == 0 else (4 * d if tag == "fo" else 4 * d * live[t])
            check(met["n_live"] == live[t] and met["comm_bytes"] == want
                  and ledger.bytes_per_step(tag) == want,
                  f"{prog.name} round {t}: n_live {met['n_live']} (cohort {live[t]}), booked "
                  f"{met['comm_bytes']} / ledger {ledger.bytes_per_step(tag)}, expected {want}")
        torch.cuda.synchronize()
        hist["launches"] = ops.launch_counts()
        hist["params"] = params
        return hist

    runs = {}
    for engine in ("flat", "pallas", "tree"):
        cfg = HOSGDConfig(tau=tau, mu=mu, m=m, lr=lr, zo_lr=lr * 30.0 / d, engine=engine)
        runs[engine] = run(ho_sgd_program(mlp_loss, cfg, client_sampling=cs), rounds)
    order = runs["tree"]["order"]
    zo_live = sum(n for n, o in zip(live, order) if o == 0)
    n_zo = order.count(0)
    want = {"flat": {"zo_perturb_flat": zo_live, "zo_reconstruct_flat": n_zo},
            "pallas": {"zo_perturb": n_leaves * zo_live, "zo_reconstruct": n_leaves * n_zo},
            "tree": {}}
    smi = smi_line()
    for engine, h in runs.items():
        launched = {k: v for k, v in h["launches"].items() if v}
        check(launched == want[engine], f"fed-HO {engine}: launches {launched}, expected "
              f"{want[engine]}")
        check(all(math.isfinite(v) for v in h["loss"]), f"fed-HO {engine}: non-finite loss")
        # the flat and per-leaf kernels equal their plain versions bit for bit
        # (kernel phase), and the Σv² is the shared plain reduction: the
        # losses are the tree engine's exactly
        rel = max(abs(a - b) / abs(b) for a, b in zip(h["loss"], runs["tree"]["loss"]))
        check(h["order"] == order and h["loss"] == runs["tree"]["loss"],
              f"fed-HO {engine} vs tree: losses differ, max relative difference {rel}")
        print(f"  fed-HO {engine:6s} ({rounds} rounds, cohorts {live}): loss "
              f"{h['loss'][0]:.5f} -> {h['loss'][-1]:.5f}, vs tree {rel:.3e} (bit for bit); "
              f"ms per round FO {round_times(h['s'], h['order'], 1):.3f}, ZO "
              f"{round_times(h['s'], h['order'], 0):.3f} [{smi}]; launches {launched}")
    fed = run(fed_avg_program(mlp_loss, cs, lr=lr, local_steps=2), fedavg_rounds)
    check(not any(fed["launches"].values()), f"FedAvg launched a ZO kernel: {fed['launches']}")
    check(all(math.isfinite(v) for v in fed["loss"]) and
          all(bool(torch.isfinite(p).all()) for p in fed["params"].values()),
          "FedAvg: non-finite loss or parameters")
    print(f"  FedAvg ({fedavg_rounds} rounds, local_steps=2): loss {fed['loss'][0]:.5f} -> "
          f"{fed['loss'][-1]:.5f}; 4*d*n_live bytes per round; ms per round "
          f"{1e3 * statistics.median(fed['s'][1:]):.3f} (first round excluded) [{smi}]")
    return {"flat": runs["flat"]["launches"], "pallas": runs["pallas"]["launches"]}


def distributed_rank(rank, world, dev_type, hidden, steps, m, B, tau):
    """One rank of ``distributed_phase`` (b): its worker's rows, the
    rank-per-worker steps on ``cuda:0`` (every rank: one card); returns
    losses, step times, the ledger's bytes and this rank's kernel launches."""
    import torch

    from repro_torch.core import HOSGDConfig
    from repro_torch.core.distributed import make_distributed_ho_sgd
    from repro_torch.data.pipeline import shard_batches
    from repro_torch.data.synthetic import batches
    from repro_torch.dist import CommLedger
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.mlp import mlp_loss

    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device(dev_type)
    ds, params, d = fig2_setup(torch, dev, hidden)
    mesh = make_test_mesh(data=world, model=1, device=dev_type)
    cfg = HOSGDConfig(tau=tau, mu=1e-3, m=m, lr=0.05, zo_lr=0.05 * 30.0 / d, engine="flat")
    fo, zo = make_distributed_ho_sgd(mlp_loss, mesh, cfg)
    ledger = CommLedger()
    fo, zo = ledger.wrap("fo", fo), ledger.wrap("zo", zo)
    state, losses, secs = (), [], []
    host = (b for _, b in zip(range(steps), batches(ds, m * B, seed=1)))
    ops.reset_launch_counts()
    for t, b in enumerate(shard_batches(host, mesh)):
        ts = time.perf_counter()
        params, state, loss = (fo if t % tau == 0 else zo)(t, params, state, b)
        losses.append(float(loss))
        secs.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    return {"losses": losses, "s": secs, "launches": ops.launch_counts(),
            "fo_bytes": ledger.bytes_per_step("fo"), "zo_bytes": ledger.bytes_per_step("zo"),
            "zo_kinds": ledger.by_kind("zo"), "checksum": float(sum(
                p.double().sum() for p in params.values())),
            "params": ({k: v.cpu().numpy() for k, v in params.items()} if rank == 0 else None)}


def distributed_phase(torch, dev, hidden=1300, steps_a=32, steps_b=16, timeout=600.0):
    """HO-SGD through ``make_distributed_ho_sgd`` at m=4, B=64, tau=8: (a) one
    process holding the four workers (a one-rank gloo group; engine flat,
    plain SGD: the fused round), against ``make_ho_sgd``'s flat path; (b)
    four gloo ranks spawned on ``cuda:0``, one per worker, against (a)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import HOSGDConfig, make_ho_sgd
    from repro_torch.core.distributed import make_distributed_ho_sgd
    from repro_torch.data.synthetic import batches
    from repro_torch.dist import CommLedger
    from repro_torch.kernels import ops
    from repro_torch.kernels import zo_direction as cu
    from repro_torch.launch.mesh import init_rank, make_test_mesh, spawn_ranks
    from repro_torch.models.mlp import mlp_loss

    ds, p0, d = fig2_setup(torch, dev, hidden)
    m, B, tau = 4, 64, 8
    cfg = HOSGDConfig(tau=tau, mu=1e-3, m=m, lr=0.05, zo_lr=0.05 * 30.0 / d, engine="flat")
    host = [b for _, b in zip(range(steps_a), batches(ds, m * B, seed=1))]
    smi = smi_line()
    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, 1, str(Path(tmp) / "init"))
        try:
            mesh = make_test_mesh(data=1, model=1, device=dev.type)
            fo, zo = make_distributed_ho_sgd(mlp_loss, mesh, cfg)
            ledger = CommLedger()
            fo, zo = ledger.wrap("fo", fo), ledger.wrap("zo", zo)
            params, state, la, secs = p0, (), [], []
            ops.reset_launch_counts()
            for t, b in enumerate(host):
                ts = time.perf_counter()
                params, state, loss = (fo if t % tau == 0 else zo)(t, params, state, b)
                la.append(float(loss))
                secs.append(time.perf_counter() - ts)
                if t + 1 == steps_b:                    # (b)'s end, held below
                    p_b_ref = {k: v.double().cpu() for k, v in params.items()}
            torch.cuda.synchronize()
            launches_a = ops.launch_counts()
        finally:
            dist.destroy_process_group()
    ref = make_ho_sgd(mlp_loss, cfg)
    params, state, lr_ = p0, ref.init(p0), []
    for t, b in enumerate(host):
        params, state, met = ref.step(t, params, state, b)
        lr_.append(float(met["loss"]))
    order = [1 if t % tau == 0 else 0 for t in range(steps_a)]
    n_zo = order.count(0)
    per_call = cu.LAUNCHES_PER_CALL["zo_perturb_sumsq"]
    launched = {k: v for k, v in launches_a.items() if v}
    check(launched == {"zo_perturb_sumsq": per_call * m * n_zo, "zo_reconstruct_update": n_zo},
          f"distributed (a): launches {launched}")
    # the same fused kernels in the same order on the same inputs: bit for bit
    check(la == lr_, f"distributed (a) vs make_ho_sgd: losses differ {la[:4]} {lr_[:4]}")
    check(ledger.bytes_per_step("zo") == 4 * m and ledger.bytes_per_step("fo") == 4 * d,
          f"distributed (a): ledger {ledger.summary()}")
    print(f"  (a) one process, m={m}, {steps_a} steps: losses equal make_ho_sgd's flat path "
          f"bit for bit ({la[0]:.6f} -> {la[-1]:.6f}); {ledger.bytes_per_step('fo')} B per FO "
          f"step, {ledger.bytes_per_step('zo')} B per ZO step; ms per step FO "
          f"{round_times(secs, order, 1):.3f}, ZO {round_times(secs, order, 0):.3f} [{smi}]; "
          f"launches {launched}")

    with tempfile.TemporaryDirectory() as tmp:
        try:
            res = spawn_ranks(distributed_rank, m, str(Path(tmp) / "init"), dev.type, hidden,
                              steps_b, m, B, tau, timeout=timeout)
        except (RuntimeError, TimeoutError) as e:
            fail(f"distributed (b): {e}")
    r0 = res[0]
    check(all(r["checksum"] == r0["checksum"] and r["losses"] == r0["losses"] for r in res),
          "distributed (b): the ranks' parameters or losses differ")
    # the same coefficients and directions on every path; the FO mean is
    # summed over the ranks in another order than (a)'s batch mean, and the
    # ZO coefficients after it amplify that: the CPU tests' tolerances
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], la[:steps_b]))
    check(all(math.isfinite(v) for v in r0["losses"]) and rel <= 1e-6,
          f"distributed (b) vs (a): max relative loss difference {rel}")
    step_max = max(float((p_b_ref[k] - p0[k].double().cpu()).abs().max()) for k in p_b_ref)
    p_err = max(float((torch.from_numpy(v).double() - p_b_ref[k]).abs().max())
                for k, v in r0["params"].items())
    check(p_err <= 0.02 * step_max,
          f"distributed (b) vs (a) after {steps_b} steps: parameters differ by {p_err}, "
          f"more than 2% of the update {step_max}")
    check(r0["zo_bytes"] == 4 * m and r0["fo_bytes"] == 4 * d,
          f"distributed (b) rank 0 ledger: {r0['fo_bytes']} B per FO step, {r0['zo_bytes']} "
          f"per ZO step; expected {4 * d} and {4 * m}")
    order_b = order[:steps_b]
    n_zo_b = order_b.count(0)
    total = {k: sum(r["launches"][k] for r in res) for k in r0["launches"]}
    launched_b = {k: v for k, v in total.items() if v}
    check(launched_b == {"zo_perturb_flat": m * n_zo_b, "zo_reconstruct_flat": m * n_zo_b},
          f"distributed (b): launches over the ranks {launched_b}")
    print(f"  (b) {m} gloo ranks on cuda:0, {steps_b} steps: vs (a) max relative loss "
          f"difference {rel:.3e} (tol 1e-6), parameters {p_err:.3e} from (a)'s (tol 2% of "
          f"the update {step_max:.3e}); rank 0 books {r0['fo_bytes']} B per FO step, "
          f"{r0['zo_bytes']} B per ZO step ({r0['zo_kinds']}); rank 0 ms per step FO "
          f"{round_times(r0['s'], order_b, 1):.3f}, ZO {round_times(r0['s'], order_b, 0):.3f} "
          f"[{smi}]; launches over the ranks {launched_b}")
    return {"a": launches_a, "b": total}


# --------------------------------------------------------------------------- #
# phase 8d: the LLM trainer, launch.train's main, at gemma2-2b's full width
# --------------------------------------------------------------------------- #
TRAIN_FLAGS = ["--arch", "gemma2-2b", "--tau", "3", "--batch", "8", "--seq", "128"]
TRAIN_FULL = "train gemma2-2b --reduce full, engine=flat"
TRAIN_100M = "train gemma2-2b --reduce 100m, engine=pallas"
TWO31 = 1 << 31


def sampled_blocks(torch, ctrs, block, n_past=48):
    """``(block indices, leaves, blocks past element 2^31)``: each leaf's
    first and last block of a packed buffer (a leaf starts where its
    counter is 0), the block holding element 2^31, the buffer's last block
    and ``n_past`` blocks spread between them."""
    import numpy as np

    nb = int(ctrs.shape[0])
    firsts = np.flatnonzero(ctrs.view(torch.int32).cpu().numpy() == 0)
    lasts = np.append(firsts[1:] - 1, nb - 1)
    past = (np.linspace(TWO31 // block, nb - 1, n_past).astype(np.int64)
            if nb * block > TWO31 else np.zeros(0, np.int64))
    idx = np.unique(np.concatenate([firsts, lasts, past]))
    return torch.from_numpy(idx).to(ctrs.device), len(firsts), len(np.unique(past))


def block_rows(torch, t, idx):
    """Rows ``idx`` of a per-block uint32 (or int32) table, indexed as int32."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)[idx].contiguous().view(torch.uint32)
    return t[idx].contiguous()


class TrainProbe:
    """Instruments a ``launch.train.main`` run from outside, without
    touching its arithmetic: each step's peak memory and the last
    parameters (by wrapping the steps that ``make_distributed_ho_sgd``
    returns); the kernels' output in the first ZO step held against the
    plain versions, the flat ones on sampled blocks and the per-leaf ones on
    windows of every leaf; and, in the steps that
    ``profile`` names (kind -> its k-th step of that kind), the profiler's
    device time with the step split by CUDA events into the plain sums of
    squares (``DirectionEngine.sumsq``), the loss forwards and the
    kernels."""

    def __init__(self, torch, dev, profile=None):
        self.torch, self.dev, self.profile_at = torch, dev, profile or {}
        self.start_gb = {"fo": [], "zo": []}     # allocated when the step starts
        self.reset_gb = {"fo": [], "zo": []}     # the peak just after its reset
        self.peak_gb = {"fo": [], "zo": []}
        self.params = None
        self.n = {"fo": 0, "zo": 0}
        self.checking = False
        self.held = {}                # kernel -> [blocks or windows, leaves, past 2^31, ok, max err]
        self.parts = None             # part -> [(start event, end event)]
        self.peaks = []               # (part, the step's peak so far when it ended)
        self.profile = {}             # kind -> what profiled() measured

    def timed(self, part, fn):
        def run(*a, **kw):
            if self.parts is None:
                return fn(*a, **kw)
            s = self.torch.cuda.Event(enable_timing=True)
            e = self.torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.parts.setdefault(part, []).append((s, e))
            self.peaks.append((part, self.torch.cuda.max_memory_allocated(self.dev) / 1e9))
            return out
        return run

    def hold(self, name, out, x, salts, ctrs, nvalid, block, plain):
        """``out`` (the kernel's buffer) against ``plain`` on sampled blocks."""
        torch = self.torch
        idx, leaves, past = sampled_blocks(torch, ctrs, block)
        rows = lambda t: block_rows(torch, t, idx)                  # noqa: E731
        got = out.view(-1, block)[idx].reshape(-1)
        base = None if x is None else x.view(-1, block)[idx].reshape(-1)
        want = plain(base, rows(salts), rows(ctrs), rows(nvalid))
        ok, err, tol = agree(torch, got, want, base=base)
        self.held[name] = [int(idx.numel()), leaves, past, ok, err]
        print(f"  {name:20s} first ZO step: {idx.numel()} sampled blocks ({leaves} leaves' "
              f"first and last, {past} past element 2^31 of {out.numel():,}) vs the plain "
              f"version: max abs err {err:.3e} ({tol}) ok={ok}")

    def hold_leaf(self, name, out, x, plain, offset, n, bf16, window=4096):
        """One leaf's ``out`` (of ``n`` elements, the kernel's) against
        ``plain(base, lo, w)`` on its first, middle and last ``window``
        elements; ``held[name]`` sums the windows and leaves over a step."""
        torch = self.torch
        w = min(window, n)
        oks, err = [], 0.0
        for lo in sorted({0, (n - w) // 2, n - w}):
            base = None if x is None else x[lo:lo + w]
            ok, e, tol = agree(torch, out[lo:lo + w], plain(base, offset + lo, w),
                               base=base, bf16=bf16)
            oks.append(ok)
            err = max(err, e)
        h = self.held.setdefault(name, [0, 0, 0, True, 0.0, tol])
        h[0] += len(oks)
        h[1] += 1
        h[3] = h[3] and all(oks)
        h[4] = max(h[4], err)
        h[5] = tol

    def install(self, stack):
        """Patch the trainer's step factory, the flat and per-leaf kernels'
        wrappers, the plain sum of squares and the loss; ``stack`` undoes
        each patch."""
        from repro_torch.core import engine as E
        from repro_torch.kernels import ops, ref
        from repro_torch.launch import train as TT
        from repro_torch.models import transformer as T

        def patch(obj, attr, new):
            old = getattr(obj, attr)
            setattr(obj, attr, new)
            stack.callback(setattr, obj, attr, old)
            return old

        make = TT.make_distributed_ho_sgd
        pf, rf = ops.zo_perturb_flat, ops.zo_reconstruct_flat
        pl, rl = ops.zo_perturb, ops.zo_reconstruct

        def perturb_flat(x, salts, ctrs, nvalid, scale, block=4096):
            out = pf(x, salts, ctrs, nvalid, scale, block)
            if self.checking:
                self.hold("zo_perturb_flat", out, x, salts, ctrs, nvalid, block,
                          lambda xb, s, c, n: ref.ref_zo_perturb_flat(xb, s, c, n, scale, block))
            return out

        def reconstruct_flat(salts, coeffs, ctrs, nvalid, block=4096, acc_dtype="float32"):
            out = rf(salts, coeffs, ctrs, nvalid, block, acc_dtype)
            if self.checking:
                self.hold("zo_reconstruct_flat", out, None, salts, ctrs, nvalid, block,
                          lambda _, s, c, n: ref.ref_zo_reconstruct_flat(
                              s, coeffs, c, n, block, acc_dtype))
            return out

        def perturb(x, salt, scale, offset=0):
            out = pl(x, salt, scale, offset)
            if self.checking:
                self.hold_leaf("zo_perturb", out, x,
                               lambda xb, off, w: ref.ref_zo_perturb(xb, salt, scale, off),
                               offset, x.numel(), x.dtype == torch.bfloat16)
            return out

        def reconstruct(n, salts, coeffs, offset=0, acc_dtype="float32"):
            out = rl(n, salts, coeffs, offset, acc_dtype)
            if self.checking:
                host = salts.view(torch.int32) if salts.dtype == torch.uint32 else salts
                s = [int(v) & 0xFFFFFFFF for v in host.cpu().tolist()]
                self.hold_leaf("zo_reconstruct", out, None,
                               lambda _, off, w: ref.ref_zo_reconstruct(
                                   w, s, coeffs, off, acc_dtype, device=coeffs.device),
                               offset, n, False)
            return out

        def steps(*a, **kw):
            fo, zo = make(*a, **kw)
            return self.step("fo", fo), self.step("zo", zo)

        torch = self.torch
        patch(TT, "make_distributed_ho_sgd", steps)
        patch(ops, "zo_perturb_flat", self.timed("kernels", perturb_flat))
        patch(ops, "zo_reconstruct_flat", self.timed("kernels", reconstruct_flat))
        patch(ops, "zo_perturb", self.timed("kernels", perturb))
        patch(ops, "zo_reconstruct", self.timed("kernels", reconstruct))
        patch(E.DirectionEngine, "sumsq", self.timed("plain sum of squares",
                                                      E.DirectionEngine.sumsq))
        patch(T, "loss_fn", self.timed("loss forwards", T.loss_fn))

    def step(self, kind, fn):
        torch, dev = self.torch, self.dev

        def run(t, params, opt_state, batch):
            k = self.n[kind]
            self.checking = kind == "zo" and k == 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            self.start_gb[kind].append(torch.cuda.memory_allocated(dev) / 1e9)
            self.reset_gb[kind].append(torch.cuda.max_memory_allocated(dev) / 1e9)
            if self.profile_at.get(kind) == k:
                out = self.profiled(kind, fn, t, params, opt_state, batch)
            else:
                out = fn(t, params, opt_state, batch)
                torch.cuda.synchronize()
            self.peak_gb[kind].append(torch.cuda.max_memory_allocated(dev) / 1e9)
            self.checking = False
            self.n[kind] += 1
            self.params = out[0]
            return out
        return run

    def profiled(self, kind, fn, *args):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self.parts, self.peaks = {}, []
        # the device's activity only: recording every host operation of a
        # step of ~50k operations slows the host, and its teardown takes a
        # minute (a CPU rehearsal has no device activity to record)
        acts = [ProfilerActivity.CUDA if self.dev.type == "cuda" else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        parts = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.parts.items()}
        self.parts = None
        rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(r[0] for r in rows) / 1e3 if rows else None
        kern = sum(r[0] for r in rows if "perturb_flat_kernel" in r[2]
                   or "reconstruct_kernel" in r[2]) / 1e3
        self.profile[kind] = {"wall_ms": wall, "busy_ms": busy, "kernels_device_ms": kern,
                              "parts_ms": parts, "top": sorted(rows, reverse=True)[:8],
                              "peaks_gb": [(k, round(v, 2)) for k, v in self.peaks]}
        return out


def train_run(torch, dev, argv, profile=None, extra=None):
    """``launch.train.main(argv)`` under a ``TrainProbe`` (and ``extra(stack)``,
    more patches undone with the probe's), with the launch counts set to 0
    just before and read just after; returns the probe, the CSV rows and
    the launches."""
    import csv
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import train as TT
    from repro_torch.obs import load_trace_events, spans_from_events

    probe = TrainProbe(torch, dev, profile)
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        probe.install(stack)
        if extra is not None:
            extra(stack)
        log, trace = str(Path(tmp) / "log.csv"), str(Path(tmp) / "trace.json")
        ops.reset_launch_counts()
        TT.main(argv + ["--device", dev.type, "--log", log, "--trace", trace])
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        with open(log) as f:
            rows = list(csv.DictReader(f))
        spans = spans_from_events(load_trace_events(trace))
    steps = [s for s in spans if s.kind == "compute"]
    check([s.name for s in steps] == [f"{'fo' if r['order'] == '1' else 'zo'}/{r['step']}"
                                      for r in rows]
          and [s.nbytes for s in steps] == [int(r["comm_bytes"]) for r in rows],
          f"train {argv}: the trace's spans do not match the CSV's steps")
    return probe, rows, launches


def train_phase(torch, dev, gauss_instr, reduce_a="full", steps_a=6, reduce_b="100m",
                steps_b=8):
    """(a) ``launch.train.main`` on gemma2-2b ``--reduce full`` (d =
    2,614,341,888, bf16, grad_accum 8) with ``--engine flat``: 6 steps at
    tau 3, batch 8, seq 128; finite losses, the order F Z Z F Z Z, 4·d bytes
    per FO step and 4 per ZO step, one zo_perturb_flat and one
    zo_reconstruct_flat launch per ZO step, the first ZO step's kernel
    outputs against the plain versions on sampled blocks (past element 2^31
    too), the trace against the CSV; ms and peak memory per step kind and
    profiles of the first FO and the last ZO step; then rows 3 and 4 timed
    at this buffer.
    (b) ``--reduce 100m`` (float32, d = 75,522,816), 8 steps with engine
    flat (saving ``--ckpt``), pallas and tree: flat and pallas losses equal
    to tree's bit for bit; in the first ZO step the flat kernels' outputs on
    sampled blocks, and the per-leaf kernels' on the first, middle and last
    4096 elements of every leaf, against the plain versions (rtol 1e-5 of
    the change, as ``agree``); ``checkpoint.restore`` equal to the flat
    run's parameters bit for bit on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlatEngine
    from repro_torch.kernels import zo_direction as cu
    from repro_torch.launch.train import size_override

    smi = smi_line()
    out = {}
    cfg_a = size_override(get_config("gemma2-2b"), reduce_a)
    d = cfg_a.param_count()
    argv = TRAIN_FLAGS + ["--reduce", reduce_a, "--steps", str(steps_a), "--engine", "flat"]
    t0 = time.perf_counter()
    # the first FO step is profiled (the profiler's teardown lengthens its
    # host time, which the first allocations lengthen anyway), so the second
    # is timed clean; the last ZO step is profiled
    n_zo = steps_a - len(range(0, steps_a, 3))
    probe, rows, launches = train_run(torch, dev, argv, profile={"fo": 0, "zo": n_zo - 1})
    wall_a = time.perf_counter() - t0
    order = [int(r["order"]) for r in rows]
    losses = [float(r["loss"]) for r in rows]
    check(order == [1 if t % 3 == 0 else 0 for t in range(steps_a)],
          f"train (a): FO/ZO order {order}")
    check(all(math.isfinite(v) for v in losses), f"train (a): non-finite loss {losses}")
    check([int(r["comm_bytes"]) for r in rows] == [4 * d if o else 4 for o in order],
          f"train (a): comm_bytes {[r['comm_bytes'] for r in rows]}, expected {4 * d} on FO "
          f"steps and 4 on ZO steps")
    check(launches == {"zo_perturb_flat": n_zo, "zo_reconstruct_flat": n_zo},
          f"train (a): launches {launches}, expected one zo_perturb_flat and one "
          f"zo_reconstruct_flat per ZO step ({n_zo})")
    for name in ("zo_perturb_flat", "zo_reconstruct_flat"):
        held = probe.held.get(name)
        check(held is not None and held[3], f"train (a): {name} disagrees with its plain "
              f"version on the sampled blocks: {held}")
        check(held[2] > 0 or reduce_a != "full",
              f"train (a): no block past element 2^31 was checked for {name}")
    dt = {o: [1e3 * float(r["dt"]) for r in rows if int(r["order"]) == o] for o in (0, 1)}
    print(f"  (a) gemma2-2b --reduce {reduce_a} (d={d:,}, {cfg_a.dtype}, grad_accum "
          f"{cfg_a.grad_accum}), engine=flat, {steps_a} steps in {wall_a:.1f} s: losses "
          f"{[round(v, 4) for v in losses]}; {4 * d} B per FO step, 4 per ZO step; launches "
          f"{launches} [{smi}]")
    print(f"  ms per step (host, to the loss on the host): FO {[round(v, 1) for v in dt[1]]}, "
          f"ZO {[round(v, 1) for v in dt[0]]} (profiled: the first FO step and the last ZO "
          f"step; the first ZO step holds the kernels against the plain versions)")
    for kind in ("fo", "zo"):
        print(f"  {kind.upper()} steps' memory (GB, torch.cuda): allocated at the start "
              f"{[round(v, 2) for v in probe.start_gb[kind]]}, the peak just after its "
              f"reset {[round(v, 2) for v in probe.reset_gb[kind]]}, peak "
              f"{[round(v, 2) for v in probe.peak_gb[kind]]}")
    for kind, prof in probe.profile.items():
        if prof["busy_ms"] is None:
            print(f"  profiled {kind.upper()} step: host wall {prof['wall_ms']:.1f} ms; device "
                  f"time not measured (the profiler saw no device time)")
        else:
            print(f"  profiled {kind.upper()} step: host wall {prof['wall_ms']:.1f} ms, device "
                  f"busy {prof['busy_ms']:.1f} ms (idle share "
                  f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f}), the flat kernels "
                  f"{prof['kernels_device_ms']:.2f} ms of it")
            for us, count, key in prof["top"]:
                print(f"    {us / 1e3:9.3f} ms  {count:5d} calls  {key[:90]}")
        print(f"  the same step by CUDA events (device time from each call's start to its "
              f"end, summed per part): " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                                      prof["parts_ms"].items()))
        print(f"  its peak memory so far (GB) as each part's call ended: {prof['peaks_gb']}; "
              f"at the step's end {probe.peak_gb[kind][-1]:.2f}")
    out["a"] = {"launches": launches, "d": d, "steps": steps_a, "losses": losses,
                "fo_ms": dt[1], "zo_ms": dt[0], "start_gb": probe.start_gb,
                "peak_gb": probe.peak_gb, "profile": {
                    kind: {k: prof[k] for k in ("wall_ms", "busy_ms", "kernels_device_ms",
                                                "parts_ms", "peaks_gb")}
                    for kind, prof in probe.profile.items()},
                "held": probe.held}

    # rows 3 and 4 at this packed buffer (m = 1, as the trainer runs them)
    eng = FlatEngine(probe.params, seed=0)
    x = eng.pack(probe.params)
    probe = None
    s1, sm = eng.blk_salts(1, 0), eng.blk_salts_multi(1, [0])
    ctr, nv, B = eng._blk_ctr, eng._blk_nv, eng.block
    P, nb = eng.padded_dim, eng.n_blocks
    scale = torch.full((1,), 1e-3, device=dev)
    coeffs = torch.tensor([0.5], device=dev)
    shape = {}
    for name, fn, nbytes, ninstr in (
            ("zo_perturb_flat", lambda: cu.zo_perturb_flat(x, s1, ctr, nv, scale, B),
             2 * P * 4 + nb * 12 + 4, eng.dim * gauss_instr),
            ("zo_reconstruct_flat", lambda: cu.zo_reconstruct_flat(sm, coeffs, ctr, nv, B),
             P * 4 + nb * 12 + 4, eng.dim * gauss_instr)):
        ms = cuda_ms(torch, fn, reps=5, warmup=1)
        b, by = bound_ms(nbytes, ninstr)
        shape[name] = {"shape": f"gemma2-2b packed buffer P={P:,} ({nb:,} blocks), m=1",
                       "ms": ms, "bound_ms": b, "bound_by": by, "plain_ms": None}
        print(f"  {name:20s} at P={P:,}: ms={ms:.4f} bound_ms={b:.4f} ({by}; bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}, instructions "
              f"{ninstr / INSTR_PER_S * 1e3:.4f}); plain version not timed here (its "
              f"int64 counters alone are {8 * P / 1e9:.1f} GB) [{smi}]")
    out["shape"] = shape
    del x, eng
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 100m: flat (with a checkpoint), pallas and tree
    out["b"] = train_100m(torch, dev, TRAIN_FLAGS, reduce_b, steps_b, ckpt=True)
    return out


def train_100m(torch, dev, flags, reduce="100m", steps=8, ckpt=False, aux=False):
    """``launch.train.main(flags)`` at ``--reduce 100m`` (float32), ``steps``
    steps with engine flat (saving ``--ckpt`` when ``ckpt``), pallas and
    tree: flat and pallas losses equal to tree's bit for bit, 4·d bytes per
    FO step and 4 per ZO step; in the first ZO step the flat kernels'
    outputs on sampled blocks, and the per-leaf kernels' on the first,
    middle and last 4096 elements of every leaf, against the plain versions
    (rtol 1e-5 of the change, as ``agree``); the checkpoint restored bit for
    bit on the card.  With ``aux``, the flat run's first loss evaluation is
    held to its cross-entropy plus 0.01 times the layers' MoE aux loss,
    each computed apart (``aux_probe``).  Returns each engine's run."""
    import tempfile

    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.launch.train import size_override
    from repro_torch.tree import tree_leaves

    arch = flags[flags.index("--arch") + 1]
    cfg_b = size_override(get_config(arch), reduce)
    d_b = leaf_count(cfg_b)
    runs, aux_rec = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ck")
        for engine in ("flat", "pallas", "tree"):
            argv = flags + ["--reduce", reduce, "--steps", str(steps),
                            "--engine", engine] + (["--ckpt", ck] if ckpt and engine == "flat"
                                                   else [])
            extra = functools.partial(aux_probe, torch, aux_rec) if aux and engine == "flat" \
                else None
            probe, rows, launches = train_run(torch, dev, argv, extra=extra)
            runs[engine] = {"losses": [float(r["loss"]) for r in rows], "launches": launches,
                            "order": [int(r["order"]) for r in rows],
                            "bytes": [int(r["comm_bytes"]) for r in rows],
                            "zo_ms": statistics.median(1e3 * float(r["dt"]) for r in rows
                                                       if r["order"] == "0"),
                            "fo_ms": statistics.median(1e3 * float(r["dt"]) for r in rows
                                                       if r["order"] == "1"),
                            "params": probe.params, "held": probe.held}
        if ckpt:
            restored, step = restore(ck, runs["flat"]["params"], device=dev)
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(restored), tree_leaves(runs["flat"]["params"])))
            check(step == steps and same, f"train {arch}: the checkpoint at step {step} does "
                  f"not restore the flat run's parameters bit for bit")
    tree = runs["tree"]
    n_zo_b = tree["order"].count(0)
    n_leaves = len(tree_leaves(tree["params"]))
    expect = {"flat": {"zo_perturb_flat": n_zo_b, "zo_reconstruct_flat": n_zo_b},
              "pallas": {"zo_perturb": n_leaves * n_zo_b, "zo_reconstruct": n_leaves * n_zo_b},
              "tree": {}}
    label = f"{arch} --reduce {reduce} (d={d_b:,}, {cfg_b.dtype}, grad_accum {cfg_b.grad_accum})"
    for engine, run in runs.items():
        check(run["order"] == tree["order"] and run["bytes"] == tree["bytes"]
              and tree["bytes"] == [4 * d_b if o else 4 for o in tree["order"]],
              f"train {arch} {engine}: order {run['order']} or bytes {run['bytes']}")
        check(run["launches"] == expect[engine],
              f"train {arch} {engine}: launches {run['launches']}, expected {expect[engine]}")
        for name in expect[engine]:
            held = run["held"].get(name)
            check(held is not None and held[3] and (engine == "flat" or held[1] == n_leaves),
                  f"train {arch} {engine}: {name} disagrees with its plain version in the "
                  f"first ZO step, or not every leaf was checked: {held}")
            print(f"  {arch} {engine} {name:20s} first ZO step: {held[0]} sampled "
                  f"{'blocks' if engine == 'flat' else 'windows'} over {held[1]} leaves vs the "
                  f"plain version: max abs err {held[4]:.3e} ok={held[3]}")
        # a ZO update moves the loss by about zo_lr*|g|^2 (~1e-6 of it at the
        # CLI's zo_lr), so the losses alone cannot tell a wrong kernel: the
        # kernels' outputs are held above, and the losses must be tree's
        # bit for bit
        check(all(math.isfinite(v) for v in run["losses"]) and run["losses"] == tree["losses"],
              f"train {arch} {engine}: losses {run['losses']} are not tree's {tree['losses']} "
              f"bit for bit")
        print(f"  {label}, engine={engine}: losses {run['losses'][0]:.6f} .. "
              f"{run['losses'][-1]:.6f}, bit for bit tree's; {4 * d_b} B per FO step, 4 per ZO "
              f"step; ms per step (median) FO {run['fo_ms']:.1f}, ZO {run['zo_ms']:.1f}; "
              f"launches {run['launches']}")
    if ckpt:
        print(f"  the flat run's --ckpt restores its parameters bit for bit on the card "
              f"(step {step}, {n_leaves} leaves)")
    if aux:
        check(aux_rec["coef"] == 0.01, f"MOE_AUX_COEF is {aux_rec['coef']}, not 0.01")
        term = aux_rec["coef"] * aux_rec["aux"]
        gap = abs(aux_rec["loss"] - (aux_rec["ce"] + term))
        print(f"  {arch} flat, the first loss evaluation: loss {aux_rec['loss']:.7f} = CE "
              f"{aux_rec['ce']:.7f} + 0.01 x aux {aux_rec['aux']:.5f} (summed over "
              f"{cfg_b.n_layers} layers) to {gap:.2e}; without the term the loss would be off "
              f"by {term:.5f}")
        check(gap <= 1e-6 * abs(aux_rec["loss"]) and term > 1e-4 * abs(aux_rec["loss"]),
              f"train {arch}: the loss is not its CE plus 0.01 x the MoE aux loss: {aux_rec}")
    return {e: {k: v for k, v in run.items() if k != "params"} for e, run in runs.items()}


def aux_probe(torch, rec, stack):
    """Wrap ``transformer.loss_fn`` from outside: on its first call, also
    the same batch's cross-entropy alone (``MOE_AUX_COEF`` set to 0 for one
    call) and the layers' summed aux loss (``forward_hidden``), into
    ``rec``."""
    from repro_torch.models import transformer as T

    inner = T.loss_fn

    def loss_fn(cfg, params, batch, shards=None):
        out = inner(cfg, params, batch, shards)
        if not rec:
            coef = T.MOE_AUX_COEF
            with torch.no_grad():
                _, aux = T.forward_hidden(cfg, params,
                                          T.embed_batch(cfg, params, batch, shards), shards)
                T.MOE_AUX_COEF = 0.0
                try:
                    ce = inner(cfg, params, batch, shards)
                finally:
                    T.MOE_AUX_COEF = coef
            rec.update(loss=float(out.detach()), ce=float(ce), aux=float(aux), coef=coef)
        return out

    T.loss_fn = loss_fn
    stack.callback(setattr, T, "loss_fn", inner)


# --------------------------------------------------------------------------- #
# phase 8d (sharded): the reference's placements on gloo ranks sharing cuda:0
# --------------------------------------------------------------------------- #
SHARDED_FULL = "train gemma2-2b --reduce full --model-axis 2 (2 gloo ranks), engine=flat"
#: (b): arch -> its flags at --reduce 100m, 8 steps at tau 4 on (data=2, model=2)
SHARDED_100M = {"gemma2-2b": ["--arch", "gemma2-2b", "--tau", "4", "--batch", "16",
                              "--seq", "128"],
                "arctic-480b": ["--arch", "arctic-480b", "--tau", "4", "--batch", "16",
                                "--seq", "128"]}
#: the leaves whose blocks (a) holds on rank 0: a column-sharded one and the
#: row-sharded embedding
SHARD_LEAVES = (("layers", "attn", "wk"), ("embed",))


def sharded_path(arch):
    return f"train {arch} --reduce 100m --model-axis 2 (4 gloo ranks), engine=flat"


class ShardProbe(TrainProbe):
    """A ``TrainProbe`` for a rank of a sharded trainer: also the engine the
    steps build (``ho_sgd.make_engine``), the whole-tree shapes
    (``launch.train.init_params``), at each step's start the parameter
    bytes the rank holds, and the host seconds spent in the gathers
    (``collectives.gather_cat``, after a synchronize, so that a gather's
    time is its own and not the compute queued before it).  The flat
    kernels' outputs in the first ZO step are held on sampled blocks of
    this rank's packed shard, among them blocks of ``SHARD_LEAVES``,
    against the plain versions, and against a control: the plain versions
    with each block's counters local to the shard (its position in the
    leaf's shard), which must disagree."""

    def __init__(self, torch, dev, hold=True):
        super().__init__(torch, dev)
        self.holding = hold
        self.engine, self.like, self.paths = None, None, None
        self.gather_s, self.gather_bytes, self.gathers = 0.0, 0, 0
        self.step_gather_s = {"fo": [], "zo": []}
        self.step_gather_bytes = {"fo": [], "zo": []}
        self.held_bytes = {"fo": [], "zo": []}

    def install(self, stack):
        from repro_torch.core import ho_sgd as HS
        from repro_torch.dist import collectives as coll
        from repro_torch.launch import train as TT

        super().install(stack)
        torch = self.torch

        def patch(obj, attr, new):
            old = getattr(obj, attr)
            setattr(obj, attr, new)
            stack.callback(setattr, obj, attr, old)
            return old

        make = HS.make_engine

        def make_engine(*a, **kw):
            self.engine = make(*a, **kw)
            return self.engine

        init = TT.init_params

        def init_params(*a, **kw):
            params, self.like = init(*a, **kw)
            return params, self.like

        gather_cat = coll.gather_cat

        def timed_gather(x, axes, *, mesh, dim):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gather_cat(x, axes, mesh=mesh, dim=dim)
            torch.cuda.synchronize()
            self.gather_s += time.perf_counter() - t0
            self.gather_bytes += out.numel() * out.element_size()
            self.gathers += 1
            return out

        patch(HS, "make_engine", make_engine)
        patch(TT, "init_params", init_params)
        patch(coll, "gather_cat", timed_gather)

    def step(self, kind, fn):
        inner = super().step(kind, fn)

        def run(t, params, opt_state, batch):
            from repro_torch.dist.sharding import map_with_paths
            from repro_torch.tree import tree_leaves

            if self.paths is None:
                self.paths = []
                map_with_paths(lambda names, x: self.paths.append(tuple(names)), params)
            self.held_bytes[kind].append(
                sum(x.numel() * x.element_size() for x in tree_leaves(params)))
            g0, b0 = self.gather_s, self.gather_bytes
            out = inner(t, params, opt_state, batch)
            self.step_gather_s[kind].append(self.gather_s - g0)
            self.step_gather_bytes[kind].append(self.gather_bytes - b0)
            return out
        return run

    def hold(self, name, out, x, salts, ctrs, nvalid, block, plain):
        import numpy as np

        torch, eng = self.torch, self.engine
        if not self.holding or eng is None or eng.geometry is None:
            return
        leaf_of = eng._blk_leaf
        first = np.searchsorted(leaf_of, np.arange(len(eng._row)))
        picks = [np.linspace(0, len(leaf_of) - 1, 32).astype(np.int64)]
        for path in SHARD_LEAVES:
            i = self.paths.index(path)
            nb = int(np.count_nonzero(leaf_of == i))
            k = np.unique(np.concatenate([np.arange(8), nb - 1 - np.arange(8),
                                          np.linspace(0, nb - 1, 16).astype(np.int64)]))
            picks.append(first[i] + k[(k >= 0) & (k < nb)])
        idx_np = np.unique(np.concatenate(picks))
        # each sampled block's counters as if the shard were a leaf of its own
        lf = leaf_of[idx_np]
        k = idx_np - first[lf]
        per_run = np.asarray([eng._row[i][2] // block for i in lf])
        run_len = np.asarray([eng._row[i][1] for i in lf])
        local = (k // per_run) * run_len + (k % per_run) * block
        idx = torch.from_numpy(idx_np).to(ctrs.device)
        rows = lambda t: block_rows(torch, t, idx)                  # noqa: E731
        got = out.view(-1, block)[idx].reshape(-1)
        base = None if x is None else x.view(-1, block)[idx].reshape(-1)
        want = plain(base, rows(salts), rows(ctrs), rows(nvalid))
        ok, err, tol = agree(torch, got, want, base=base)
        local_ctrs = torch.from_numpy(local.astype(np.uint32)).to(ctrs.device)
        wrong = plain(base, rows(salts), local_ctrs, rows(nvalid))
        control, _, _ = agree(torch, got, wrong, base=base)
        leaves = [self.paths[i] for i in np.unique(lf)]
        column = int(np.isin(lf, [self.paths.index(SHARD_LEAVES[0])]).sum())
        self.held[name] = [int(idx.numel()), len(leaves), column, ok, err, control]
        print(f"  {name:20s} rank 0's first ZO step: {idx.numel()} sampled blocks of its "
              f"packed shard ({len(leaves)} leaves, {column} of the column-sharded "
              f"{'/'.join(SHARD_LEAVES[0])}, and {'/'.join(SHARD_LEAVES[1])}'s) vs the plain "
              f"version: max abs err {err:.3e} ({tol}) ok={ok}; with shard-local counters "
              f"(the control) ok={control}", flush=True)


def sharded_rank(rank, world, argv, log, hold, ref_path, dev_type):
    """One rank of ``sharded_phase``: ``launch.train.main(argv)`` under the
    group on ``cuda:0`` with a ``ShardProbe``; returns what the phase holds:
    the launches, per-step memory, parameter bytes and gather time, the
    shards' bytes, a checksum of the leaves no axis cuts, and with
    ``ref_path`` (the replicated run's first and final parameters) this
    rank's shards against their slices of the final ones."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as TT
    from repro_torch.tree import tree_leaves

    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device(dev_type)
    probe = ShardProbe(torch, dev, hold=hold and rank == 0)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        probe.install(stack)
        ops.reset_launch_counts()
        TT.main(argv + ["--device", dev_type, "--log", log])
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
    geom = probe.engine.geometry
    leaves = tree_leaves(probe.params)
    out = {"launches": launches, "wall_s": time.perf_counter() - t0,
           "peak_gb": probe.peak_gb, "start_gb": probe.start_gb,
           "held_bytes": probe.held_bytes, "step_gather_s": probe.step_gather_s,
           "step_gather_bytes": probe.step_gather_bytes,
           "gather_s": probe.gather_s, "gather_bytes": probe.gather_bytes,
           "gathers": probe.gathers, "held": probe.held, "block": probe.engine.block,
           "packed_over_shard": probe.engine.packed_over_shard,
           "shard_bytes": sum(math.prod(s) * x.element_size()
                              for s, x in zip(geom.local_shapes, leaves)),
           "global_bytes": geom.global_nbytes(leaves),
           "replicated_sum": float(sum(x.double().sum() for x, ax in zip(leaves, geom.axes)
                                       if not ax))}
    if ref_path is not None:
        ref = torch.load(ref_path)
        diff = scale = 0.0
        for i, (x, r, r0) in enumerate(zip(leaves, ref["final"], ref["start"])):
            want = r[geom.slices[i]].double()
            diff = max(diff, float((x.cpu().double() - want).abs().max()))
            scale = max(scale, float((want - r0[geom.slices[i]].double()).abs().max()))
        out["final_diff"], out["update_scale"] = diff, scale
    return out


def sharded_spawn(torch, dev, argv, world, log, hold=False, ref_path=None, timeout=900.0):
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        try:
            return spawn_ranks(sharded_rank, world, str(Path(tmp) / "init"), argv, log, hold,
                               ref_path, dev.type, timeout=timeout)
        except (RuntimeError, TimeoutError) as e:
            fail(f"sharded ranks ({' '.join(argv)}): {e}")


def csv_rows(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def step_ms(rows, order):
    return [1e3 * float(r["dt"]) for r in rows if int(r["order"]) == order]


def sharded_report(what, res, rows, smi):
    """Print each rank's step times, gather share, memory and bytes held."""
    r0 = res[0]
    fo, zo = step_ms(rows, 1), step_ms(rows, 0)
    share = {kind: [g / (1e-3 * t) for g, t in zip(r0["step_gather_s"][kind], ms)]
             for kind, ms in (("fo", fo), ("zo", zo))}
    print(f"  {what}: rank 0 ms per step (host, to the loss on the host) FO "
          f"{[round(v, 1) for v in fo]}, ZO {[round(v, 1) for v in zo]}; the gathers' share "
          f"of each step (host clock) FO {[round(v, 3) for v in share['fo']]}, ZO "
          f"{[round(v, 3) for v in share['zo']]}; {r0['gathers']} gathers, "
          f"{r0['gather_bytes'] / 1e9:.2f} GB gathered, {r0['gather_s']:.1f} s [{smi}]")
    for rank, r in enumerate(res):
        print(f"  {what}: rank {rank} holds {r['shard_bytes']:,} of {r['global_bytes']:,} "
              f"parameter bytes (flat block {r['block']}, packed/shard "
              f"{r['packed_over_shard']:.4f}); allocated at each step's start (GB) "
              f"{[round(v, 2) for v in r['start_gb']['fo'] + r['start_gb']['zo']]}; peak (GB) "
              f"FO {[round(v, 2) for v in r['peak_gb']['fo']]}, ZO "
              f"{[round(v, 2) for v in r['peak_gb']['zo']]}; launches {r['launches']}")
    return {"fo_ms": fo, "zo_ms": zo, "gather_share": share, "gathers": r0["gathers"],
            "gather_gb": r0["gather_bytes"] / 1e9}


def replicated_run(torch, dev, argv, m, path):
    """``launch.train.main(argv)`` in this process (a one-rank group) with
    ``m`` workers held here (``n_workers`` patched to ``m``, as the sharded
    run's (data=2, model=2) mesh counts them): its CSV rows, launches and
    first and final parameters, the latter two saved to ``path`` on the
    host for the ranks to slice."""
    from repro_torch.launch import train as TT
    from repro_torch.tree import tree_leaves

    start = {}
    init, n_workers = TT.init_params, TT.n_workers

    def init_params(*a, **kw):
        params, like = init(*a, **kw)
        start["p"] = [x.detach().cpu().clone() for x in tree_leaves(params)]
        return params, like

    def extra(stack):
        TT.init_params, TT.n_workers = init_params, (lambda mesh: m)
        stack.callback(setattr, TT, "init_params", init)
        stack.callback(setattr, TT, "n_workers", n_workers)

    probe, rows, launches = train_run(torch, dev, argv, extra=extra)
    torch.save({"start": start["p"], "final": [x.detach().cpu() for x in
                                              tree_leaves(probe.params)]}, path)
    return rows, launches


def sharded_phase(torch, dev, train_a, reduce_a="full", steps_a=3, reduce_b="100m",
                  steps_b=8):
    """Sharded placements on gloo ranks that share ``cuda:0``.

    (a) ``launch.train.main`` on gemma2-2b ``--reduce full --model-axis 2``
    (2 ranks, the (data=1, model=2) mesh; d = 2,614,341,888 bf16), engine
    flat, ``train_phase`` (a)'s seed, batch, seq and tau, ``steps_a`` steps:
    the losses of steps 0 and 1 bit for bit ``train_phase``'s (the gathered
    leaves are the whole ones, and the FO update on a model-only mesh is
    elementwise on the same gradient), step 2's within rtol 1e-6 (after the
    first ZO update, whose global sum of squares is summed in another
    order); each rank's parameter bytes at every step's start equal its
    shards'; each rank's peak below ``train_phase``'s one-process peak;
    rank 0 books 4·d per FO step and 4 bytes per ZO step; the leaves no axis
    cuts equal on both ranks; one zo_perturb_flat and one
    zo_reconstruct_flat launch per ZO step on each rank, held on rank 0 in
    the first ZO step on sampled blocks of its packed shard (a
    column-sharded leaf's and the row-sharded embedding's among them)
    against the plain versions, rtol 1e-5 of the change, with shard-local
    counters as the failing control.
    (b) ``--reduce 100m`` on (data=2, model=2) (4 ranks), ``steps_b`` steps
    at tau 4: gemma2-2b (m = 2) and arctic-480b (fsdp, MoE; m = 1 in its ZO
    steps, every rank the whole batch) against this process's replicated run
    of the same config: losses within rtol 1e-6, rank 0's final shards
    within 2% of the update of their slices of the replicated parameters
    (the rules of the process-group phase), 4·d bytes per FO step and 4·m per
    ZO step.
    Step times, the gathers' share of each step by host clock and the bytes
    gathered are printed; returns the launches by path."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import size_override

    smi = smi_line()
    out = {}
    cfg_a = size_override(get_config("gemma2-2b"), reduce_a)
    d = cfg_a.param_count()
    argv = TRAIN_FLAGS + ["--reduce", reduce_a, "--steps", str(steps_a), "--engine", "flat",
                          "--model-axis", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        log = str(Path(tmp) / "a.csv")
        t0 = time.perf_counter()
        res = sharded_spawn(torch, dev, argv, 2, log, hold=True)
        wall = time.perf_counter() - t0
        rows = csv_rows(log)
    losses = [float(r["loss"]) for r in rows]
    order = [int(r["order"]) for r in rows]
    check(order == [1 if t % 3 == 0 else 0 for t in range(steps_a)], f"sharded (a): order {order}")
    check(losses[:2] == train_a["losses"][:2],
          f"sharded (a): losses of steps 0-1 {losses[:2]} are not train_phase's "
          f"{train_a['losses'][:2]} bit for bit")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[2:], train_a["losses"][2:steps_a])]
    check(all(math.isfinite(v) for v in losses) and max(rel, default=0.0) <= 1e-6,
          f"sharded (a): steps 2.. {losses[2:]} vs train_phase's "
          f"{train_a['losses'][2:steps_a]}: relative {rel} (tol 1e-6)")
    check([int(r["comm_bytes"]) for r in rows] == [4 * d if o else 4 for o in order],
          f"sharded (a): rank 0 books {[r['comm_bytes'] for r in rows]}, expected {4 * d} per "
          f"FO step and 4 per ZO step")
    one_peak = max(max(v) for v in train_a["peak_gb"].values())
    n_zo = order.count(0)
    for rank, r in enumerate(res):
        held = r["held_bytes"]["fo"] + r["held_bytes"]["zo"]
        check(all(b == r["shard_bytes"] for b in held) and r["shard_bytes"] < r["global_bytes"],
              f"sharded (a) rank {rank}: parameter bytes held at each step's start {held}, its "
              f"shards' {r['shard_bytes']} of {r['global_bytes']}")
        peak = max(max(v) for v in r["peak_gb"].values())
        check(peak < one_peak, f"sharded (a) rank {rank}: peak {peak:.2f} GB is not below the "
              f"one-process peak {one_peak:.2f} GB")
        check(r["launches"] == {"zo_perturb_flat": n_zo, "zo_reconstruct_flat": n_zo},
              f"sharded (a) rank {rank}: launches {r['launches']}")
    check(res[0]["replicated_sum"] == res[1]["replicated_sum"],
          "sharded (a): the leaves no axis cuts differ between the ranks")
    for name in ("zo_perturb_flat", "zo_reconstruct_flat"):
        held = res[0]["held"].get(name)
        check(held is not None and held[3] and held[2] > 0,
              f"sharded (a): {name} disagrees with its plain version on rank 0's shard: {held}")
        check(not held[5], f"sharded (a): {name}'s control (shard-local counters) passed")
    print(f"  (a) gemma2-2b --reduce {reduce_a} --model-axis 2 (d={d:,}), 2 gloo ranks, "
          f"{steps_a} steps in {wall:.1f} s: losses {losses}; steps 0-1 bit for bit "
          f"train_phase's, then relative {[f'{v:.2e}' for v in rel]} (tol 1e-6); rank 0 books "
          f"{4 * d} B per FO step, 4 per ZO step; peaks (GB) "
          f"{[round(max(max(v) for v in r['peak_gb'].values()), 2) for r in res]} against the "
          f"one-process {one_peak:.2f}")
    out["a"] = {"launches": {k: sum(r["launches"].get(k, 0) for r in res)
                             for k in res[0]["launches"]},
                "rank0": {"peak_gb": res[0]["peak_gb"],
                          "step_gather_bytes": res[0]["step_gather_bytes"]},
                "losses": losses, "peak_gb": [max(max(v) for v in r["peak_gb"].values())
                                              for r in res],
                "one_process_peak_gb": one_peak, "wall_s": wall, "d": d,
                **sharded_report("(a)", res, rows, smi)}
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 100m on (data=2, model=2) against the replicated run in this process
    out["b"] = {}
    for arch, flags in SHARDED_100M.items():
        cfg_b = size_override(get_config(arch), reduce_b)
        d_b = leaf_count(cfg_b)
        m_zo = 1 if cfg_b.fsdp else 2
        argv = flags + ["--reduce", reduce_b, "--steps", str(steps_b), "--engine", "flat"]
        with tempfile.TemporaryDirectory() as tmp:
            ref = str(Path(tmp) / "ref.pt")
            rows_r, _ = replicated_run(torch, dev, argv, 2, ref)
            gc.collect()
            torch.cuda.empty_cache()
            log = str(Path(tmp) / "b.csv")
            t0 = time.perf_counter()
            res = sharded_spawn(torch, dev, argv + ["--model-axis", "2"], 4, log, ref_path=ref)
            wall = time.perf_counter() - t0
            rows = csv_rows(log)
        label = f"(b) {arch} --reduce {reduce_b} (d={d_b:,}{', fsdp' if cfg_b.fsdp else ''})"
        lr, ls = [float(r["loss"]) for r in rows_r], [float(r["loss"]) for r in rows]
        order = [int(r["order"]) for r in rows]
        check(order == [int(r["order"]) for r in rows_r] == [1 if t % 4 == 0 else 0
                                                              for t in range(steps_b)],
              f"sharded {label}: order {order}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(ls, lr))
        check(all(math.isfinite(v) for v in ls) and rel <= 1e-6,
              f"sharded {label}: losses {ls} vs the replicated {lr}: relative {rel} (tol 1e-6)")
        check([int(r["comm_bytes"]) for r in rows] == [int(r["comm_bytes"]) for r in rows_r]
              == [4 * d_b if o else 4 * m_zo for o in order],
              f"sharded {label}: bytes {[r['comm_bytes'] for r in rows]}, replicated "
              f"{[r['comm_bytes'] for r in rows_r]}")
        r0 = res[0]
        check(r0["final_diff"] <= 0.02 * r0["update_scale"] + 1e-7 and r0["update_scale"] > 0,
              f"sharded {label}: rank 0's final shards {r0['final_diff']} from the replicated "
              f"run's, more than 2% of the update {r0['update_scale']}")
        n_zo = order.count(0)
        total = {k: sum(r["launches"].get(k, 0) for r in res) for k in r0["launches"]}
        check(total == {"zo_perturb_flat": 4 * n_zo, "zo_reconstruct_flat": 4 * n_zo},
              f"sharded {label}: launches over the ranks {total}")
        for rank, r in enumerate(res):
            held = r["held_bytes"]["fo"] + r["held_bytes"]["zo"]
            check(all(b == r["shard_bytes"] for b in held),
                  f"sharded {label} rank {rank}: bytes held {held}, shards' {r['shard_bytes']}")
        print(f"  {label}, 4 gloo ranks (data=2, model=2), {steps_b} steps at tau 4 in "
              f"{wall:.1f} s: losses within {rel:.2e} of the replicated run's (tol 1e-6); "
              f"rank 0's final shards {r0['final_diff']:.3e} from it (tol 2% of the update "
              f"{r0['update_scale']:.3e}); {4 * d_b} B per FO step, {4 * m_zo} per ZO step")
        out["b"][arch] = {"launches": total, "rel": rel, "wall_s": wall,
                          "final_diff": r0["final_diff"], "update_scale": r0["update_scale"],
                          **sharded_report(label, res, rows, smi)}
    return out


# --------------------------------------------------------------------------- #
# phase 8d'': the launch tooling held to this run: the dry run, the overlap
# witness, the kernel bench
# --------------------------------------------------------------------------- #
#: the dry run's targets: train_phase (a)'s configuration (seq 128, batch 8)
#: on one rank, and rank 0 of sharded_phase (a)'s (data=1, model=2) mesh
DRYRUN_TARGETS = {"a": "1x1", "b": "1x2"}
PEAK_TOL = 0.10               # a predicted peak within 10% of the card's
OVERLAP_ARGV = ["--arch", "gemma2-2b", "--reduce", "100m", "--tau", "3", "--batch", "8",
                "--seq", "128", "--steps", "1", "--engine", "flat", "--model-axis", "2"]


def dryrun_target(mesh: str, step: str, reduce: str):
    """One ``launch.dryrun.run_one`` record of train_phase (a)'s
    configuration on ``mesh`` (a spawned process of its own: the dry run
    makes a fake process group, and runs on the CPU)."""
    import os

    os.environ["REPRO_TEST_MESH"] = mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import size_override

    flags = dict(zip(TRAIN_FLAGS[::2], TRAIN_FLAGS[1::2]))
    cfg = size_override(get_config(flags["--arch"]), reduce)
    shape = ShapeConfig("train_phase", int(flags["--seq"]), int(flags["--batch"]), "train")
    return dryrun.run_one("gemma2-2b", shape, False, step, verbose=False, cfg=cfg)


def overlap_rank(rank, world, argv, dev_type):
    """One rank of ``launch.train.main(argv)`` whose FO step rank 0 runs
    under ``torch.profiler`` (CPU and CUDA activity): the gathers counted in
    the step (``collectives.GATHERS``) and, on rank 0, ``overlap_stats`` of
    its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import collectives as coll
    from repro_torch.launch import train as TT
    from repro_torch.launch.overlap import events_of, overlap_stats

    if dev_type == "cuda":
        torch.cuda.set_device(0)
    out = {}
    make = TT.make_distributed_ho_sgd

    def steps(*a, **kw):
        fo, zo = make(*a, **kw)

        def fo_traced(*args):
            torch.cuda.synchronize()
            coll.reset_gathers()
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev_type == "cuda"
                                             else [])
            with (profile(activities=acts) if rank == 0 else contextlib.nullcontext()) as prof:
                res = fo(*args)
                torch.cuda.synchronize()
            out["gathers"] = sum(n for n, _ in coll.GATHERS.values())
            if rank == 0:
                events = events_of(prof)
                out["stats"] = overlap_stats(events)
                out["device_events"] = sum(e.on_device for e in events)
                out["device_kinds"] = len({e.name for e in events if e.on_device})
            return res
        return fo_traced, zo

    TT.make_distributed_ho_sgd = steps
    try:
        TT.main(argv + ["--device", dev_type])
    finally:
        TT.make_distributed_ho_sgd = make
    return out


def dryrun_phase(torch, dev, train_a, sharded_a, reduce="full", overlap_argv=OVERLAP_ARGV):
    """The launch tooling, held to what this run measured.

    (a) ``launch.dryrun.run_one`` prices train_phase (a)'s configuration
    (gemma2-2b ``--reduce full``, bf16, batch 8, seq 128, grad_accum 8, one
    rank) and (b) rank 0 of sharded_phase (a)'s (data=1, model=2), an FO
    and a ZO step each, in four spawned processes on the CPU (fake process
    groups, ``meta`` tensors): each predicted peak within ``PEAK_TOL`` of
    the peak ``TrainProbe`` / ``ShardProbe`` measured on the card for the
    first step of that kind (``torch.cuda.max_memory_allocated``), and (b)'s
    predicted gathered bytes of an FO step equal to rank 0's measured ones.
    (c) While they run: ``launch.train.main(overlap_argv)`` on 2 gloo ranks
    sharing the card (gemma2-2b 100m, ``--model-axis 2``, one FO step), rank
    0's step traced by ``torch.profiler``; ``launch.overlap.overlap_stats``'
    pairs equal to the gathers counted in that step.  (d)
    ``bench.kernels_bench --smoke`` on the card: every kernel row within its
    tolerance of its plain version.  Returns what it printed."""
    import multiprocessing as mp
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.bench import kernels_bench
    from repro_torch.launch.mesh import spawn_ranks

    smi = smi_line()
    out = {}
    t0 = time.perf_counter()
    with ProcessPoolExecutor(2 * len(DRYRUN_TARGETS),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = {(k, step): pool.submit(dryrun_target, mesh, step, reduce)
                   for k, mesh in DRYRUN_TARGETS.items() for step in ("fo", "zo")}
        # (c) while the dry runs work on the CPU
        with tempfile.TemporaryDirectory() as tmp:
            try:
                ranks = spawn_ranks(overlap_rank, 2, str(Path(tmp) / "init"),
                                    list(overlap_argv) + ["--log", str(Path(tmp) / "o.csv")],
                                    dev.type, timeout=600.0)
            except (RuntimeError, TimeoutError) as e:
                fail(f"overlap ranks: {e}")
        stats = ranks[0]["stats"]
        check(ranks[0]["gathers"] > 0 and stats["pairs"] == ranks[0]["gathers"],
              f"overlap (c): {stats['pairs']} collective pairs in rank 0's trace, "
              f"{ranks[0]['gathers']} gathers counted in the step")
        print(f"  (c) overlap of one sharded FO step ({' '.join(overlap_argv)}, 2 gloo ranks) "
              f"on rank 0: {stats} over {ranks[0]['device_events']} device events "
              f"({ranks[0]['device_kinds']} kernel names); {ranks[0]['gathers']} gathers "
              f"counted [{smi}]")
        out["overlap"] = {**stats, "gathers": ranks[0]["gathers"]}
        # (d) the kernel bench
        with tempfile.TemporaryDirectory() as tmp:
            bench = kernels_bench.main(["--smoke", "--device", dev.type, "--out",
                                        str(Path(tmp) / "bench.json")])
        for r in bench["kernels"]:
            if dev.type == "cuda":
                check(r.get("ok", False), f"kernels_bench (d): {r['name']} disagrees with its "
                      f"plain version: {r.get('max_abs_err')} ({r.get('tol')})")
        print(f"  (d) kernels_bench --smoke: "
              + "; ".join(f"{r['name']} {r['us_per_call']:.1f} us, err {r.get('max_abs_err', 0):.2e}"
                          for r in bench["kernels"])
              + f"; zo_round launches "
              + str({e['engine']: e['kernel_launches_counted'] for e in bench["zo_round"]["engines"]})
              + f" [{smi}]")
        out["bench"] = bench
        recs = {k: f.result() for k, f in futures.items()}
    wall = time.perf_counter() - t0
    measured = {"a": train_a["peak_gb"], "b": sharded_a["rank0"]["peak_gb"]}
    for (k, step), rec in sorted(recs.items()):
        mem = rec["memory"]
        pred = mem["peak_memory_in_bytes"] / 1e9
        got = measured[k][step][0]
        rel = abs(pred - got) / got
        print(f"  ({k}) dry run {step.upper()} of {DRYRUN_TARGETS[k]} (gemma2-2b --reduce "
              f"{reduce}, batch 8, seq 128): predicted peak {pred:.3f} GB, arguments "
              f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
              f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB; the card's first {step.upper()} step "
              f"peaked at {got:.3f} GB (relative {rel:.4f}, tol {PEAK_TOL}); flops "
              f"{rec['cost']['flops']:.4e}, bytes {rec['cost']['bytes']:.4e}, kernels "
              f"{rec['kernels']}, gathers {rec['gathers']}, run {rec['run_s']} s [{smi}]")
        check(rel <= PEAK_TOL, f"dry run ({k}) {step}: predicted peak {pred:.3f} GB, the "
              f"card's {got:.3f} GB (relative {rel:.4f} > {PEAK_TOL})")
        out[f"{k}-{step}"] = {"predicted_peak_gb": pred, "measured_peak_gb": got, "rel": rel,
                              "arguments_gb": mem["argument_size_in_bytes"] / 1e9,
                              "flops": rec["cost"]["flops"], "run_s": rec["run_s"]}
    pred_gather = recs[("b", "fo")]["collectives"]["axis_model"]
    got_gather = sharded_a["rank0"]["step_gather_bytes"]["fo"][0]
    check(pred_gather == got_gather, f"dry run (b): predicted gathered bytes of an FO step "
          f"{pred_gather:.0f}, rank 0 gathered {got_gather}")
    print(f"  (b) gathered bytes of an FO step on rank 0: predicted {pred_gather:.0f}, measured "
          f"{got_gather} ({got_gather / 1e9:.2f} GB) [{smi}]")
    out["gather_bytes"] = {"predicted": pred_gather, "measured": got_gather}
    out["wall_s"] = wall
    return out


# --------------------------------------------------------------------------- #
# phase 8e: the cluster simulator at Fig. 2's width
# --------------------------------------------------------------------------- #
#: the simulator's runs: (label, cluster kwargs of ``bandwidth_constrained``,
#: methods, the flat kernels each run must launch).  (b)'s rates give 2
#: rollbacks, and 4 leaves with 3 rejoins and 7 ZO rounds of 2-3 live
#: workers, in 32 iterations (the pricing alone decides that, not the math)
FUSED_PAIR = ("zo_perturb_sumsq", "zo_reconstruct_update")
GENERIC_PAIR = ("zo_perturb_flat", "zo_reconstruct_flat")
SIM_RUNS = (
    ("a", {}, ("ho_sgd", "sync_sgd", "zo_sgd"), FUSED_PAIR),
    ("b rollback", dict(fail_rate=1 / 60, ckpt_every=4, restart_time=5.0, seed=1),
     ("ho_sgd",), FUSED_PAIR),
    ("b elastic", dict(fail_rate=1 / 60, elastic=True, downtime=20.0, restart_time=5.0,
                       ckpt_every=8, seed=0), ("ho_sgd",), FUSED_PAIR + GENERIC_PAIR),
    ("c", dict(max_staleness=2, rel_speeds=(1.0, 1.0, 1.0, 0.5)), ("ho_sgd",), GENERIC_PAIR),
    ("d", dict(n_clients=1000, cohort_k=4, availability=0.75), ("fed_ho_sgd",), GENERIC_PAIR),
)
SIM_TRACE_FIELDS = ("trace", "steps", "orders", "comm_bytes", "active_counts", "failures",
                    "rejoins")


class SimProbe:
    """Wraps a ``SimMethod``'s monolithic step and its executor from outside:
    the host wall ms of every call (FO and ZO, each path apart, the card
    synchronised after the call) and, with a ``shadow`` (the same method on
    engine tree), every ZO call's parameter change against the shadow's
    from the same inputs: the worst |change - shadow's| / max|shadow's| over
    the leaves and calls (rounds a failure discards included)."""

    def __init__(self, torch, sm, shadow=None):
        self.torch, self.ms, self.worst, self.zo_calls = torch, {}, 0.0, 0
        sm.step = self._wrap(sm.step, "step", shadow and shadow.step)
        sm.executor.run = self._wrap(sm.executor.run, "executor",
                                     shadow and shadow.executor.run)

    def _wrap(self, fn, path, shadow):
        torch = self.torch

        def run(t, params, state, batch, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, new_state, met = fn(t, params, state, batch, *a, **kw)
            torch.cuda.synchronize()
            order = int(met["order"])
            self.ms.setdefault((path, order), []).append(1e3 * (time.perf_counter() - t0))
            if order == 0 and shadow is not None:
                want = shadow(t, params, state, batch, *a, **kw)[0]
                self.zo_calls += 1
                for k in params:
                    ref_d = want[k].float() - params[k].float()
                    scale = max(float(ref_d.abs().max()), 1e-30)
                    err = float((new[k].float() - params[k].float() - ref_d).abs().max())
                    self.worst = max(self.worst, err / scale)
            return new, new_state, met
        return run


def final_close(got, want, start, rel=0.02):
    """(ok, worst |got - want| / scale over the leaves): each leaf within
    ``rel`` of its largest |want - start| (+1e-7), the ROADMAP's rule."""
    worst, ok = 0.0, True
    for k in want:
        scale = max(float((want[k].float() - start[k].float()).abs().max()), 1e-12)
        diff = float((got[k].float() - want[k].float()).abs().max())
        ok &= diff <= rel * scale + 1e-7
        worst = max(worst, diff / scale)
    return ok, worst


def sim_phase(torch, dev, hidden=1300, n_iters=32, runs=SIM_RUNS):
    """``make_sim_methods(..., engine=...)`` and ``simulate`` at Fig. 2's
    width (covtype, d = 1,771,907, m=4, B=64, tau=8) on bandwidth-constrained
    flat clusters: (a) HO-SGD, sync-SGD and ZO-SGD; (b) HO-SGD with failures
    rolled back to checkpoints, and elastic (leaves, rejoins through
    checkpoints); (c) max_staleness 2; (d) fed-HO-SGD over 1000:4 clients.
    Each on engine flat (the kernels) and tree (no kernel): the same trace,
    orders, bytes, membership, failures and rejoins; every ZO call's
    parameter change within 2% of tree's from the same inputs (a zeroed
    reconstruction fails that), the final parameters within 2% of tree's
    change over runs with FO rounds; 4 bytes per live worker on ZO rounds
    and 4*d on FO rounds; (c) twice on flat, bit for bit, and once
    monolithic (the per-worker trace); launches per run; host ms per
    replayed call.

    Why the ZO rounds are held call by call: from the second ZO round on
    the two runs' parameters differ by rounding, and the coefficient
    (d/mu)(f1 - f0) turns the loss's rounding into ~(d/mu) * 1e-7 of noise
    per coefficient (~10-30% at d = 1.8e6), so the trajectories of a ZO-only
    run part by more than 2% (3.9% after 8 ZO-SGD steps at this width on the
    CPU); from the same inputs the fused round's change agrees with tree's
    to ~4e-4 (its blockwise sum of squares)."""
    from repro_torch.data.synthetic import batches
    from repro_torch.kernels import ops
    from repro_torch.models.mlp import mlp_loss
    from repro_torch.sim import bandwidth_constrained, compute_model_for, make_sim_methods, \
        simulate

    ds, p0, d = fig2_setup(torch, dev, hidden)
    m, B, tau, lr = 4, 64, 8, 0.05
    smi = smi_line()

    def run(label, kw, which, engine, replay="per_worker", shadow=False):
        cluster = bandwidth_constrained(m, **kw)

        def build(eng):
            return make_sim_methods(mlp_loss, p0, cluster, tau=tau, lr=lr, engine=eng,
                                    which=[which])[which]
        sm = build(engine)
        probe = SimProbe(torch, sm, build("tree") if shadow else None)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = simulate(sm, p0, batches(ds, m * B, seed=1), cluster, n_iters,
                       compute=compute_model_for(p0, cluster, B), replay=replay)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the shadow's tree calls launch nothing; they are excluded from ``ms``
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        check(res.steps[-1] == n_iters - 1 and all(math.isfinite(v) for v in res.losses),
              f"sim {label} {which} {engine}: {len(res.steps)} commits, last "
              f"{res.steps[-1]}, or a non-finite loss")
        return {"res": res, "probe": probe, "launches": launches, "wall": wall}

    def medians(probe):
        return {f"{p} {'FO' if o else 'ZO'}": statistics.median(v)
                for (p, o), v in sorted(probe.ms.items())}

    out, by_path = {}, {}
    for label, kw, methods, kernels in runs:
        for which in methods:
            tree = run(label, kw, which, "tree")
            flat = run(label, kw, which, "flat", shadow=True)
            t, f = tree["res"], flat["res"]
            for field in SIM_TRACE_FIELDS:
                check(getattr(f, field) == getattr(t, field),
                      f"sim {label} {which}: flat's {field} differs from tree's")
            check(not tree["launches"], f"sim {label} {which} tree launched {tree['launches']}")
            want = [4 * k if o == 0 else 4 * d for k, o in zip(t.active_counts, t.orders)]
            check(f.comm_bytes == want, f"sim {label} {which}: bytes {f.comm_bytes[:10]}.. "
                  f"are not 4 per live worker on ZO rounds and 4*d={4 * d} on FO rounds")
            check({"b rollback": f.failures > 0, "b elastic": f.rejoins > 0
                   and min(a for a, o in zip(f.active_counts, f.orders) if o == 0) < m,
                   "d": min(f.active_counts) < m}.get(label, True),
                  f"sim {label} {which}: the scenario did not happen (failures {f.failures}, "
                  f"rejoins {f.rejoins}, live {sorted(set(f.active_counts))})")
            probe = flat["probe"]
            zo = f.orders.count(0)
            check(probe.zo_calls >= zo and probe.worst <= 0.02,
                  f"sim {label} {which}: a ZO call's change differs from tree's from the same "
                  f"inputs by {probe.worst:.3e} of it ({probe.zo_calls} calls)")
            ok, worst = final_close(f.params, t.params, p0)
            check(ok or 1 not in f.orders,
                  f"sim {label} {which}: flat's parameters differ from tree's by {worst:.3e} "
                  f"of the change")
            for name in (kernels if zo else ()):
                check(flat["launches"].get(name, 0) > 0,
                      f"sim {label} {which}: {name} was not launched ({flat['launches']})")
            by_path[f"sim ({label}) {which} engine=flat"] = flat["launches"]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(f.losses, t.losses))
            ms, tms, s = medians(probe), medians(tree["probe"]), f.summary()
            print(f"  sim ({label}) {which}: {len(f.steps)} commits ({n_iters} iterations), "
                  f"failures {f.failures}, rejoins {f.rejoins}, live "
                  f"{sorted(set(f.active_counts))}; trace, bytes and membership = tree's; "
                  f"{probe.zo_calls} ZO calls within {probe.worst:.2e} of tree's change from "
                  f"the same inputs; final parameters {worst:.2e} of the change from tree's"
                  f"{'' if 1 in f.orders else ' (ZO only: not held)'}; losses rel "
                  f"{loss_rel:.2e}; launches {flat['launches']}")
            print(f"    host wall ms per replayed call (median, card synchronised) flat "
                  + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
                  + "; tree " + ", ".join(f"{k} {v:.2f}" for k, v in tms.items())
                  + f"; whole run {tree['wall']:.2f} s tree [{smi}]")
            print(f"    simulated (FLOP and alpha-beta models, not card time): sim_seconds "
                  f"{s['sim_seconds']:.3f}, compute_s {s['compute_s']:.3f}, comm_s "
                  f"{s['comm_s']:.3f}, bytes_per_worker {s['bytes_per_worker']}, final_loss "
                  f"{s['final_loss']:.6f}")
            out[(label, which)] = {"ms": ms, "tree_ms": tms}
    # (c) twice more on flat: the determinism contract on the card, and the
    # monolithic replay (the per-worker trace, the fused pair every round)
    label, kw = "c", next(r[1] for r in runs if r[0] == "c")
    first = run(label, kw, "ho_sgd", "flat")
    again = run(label, kw, "ho_sgd", "flat")
    check(again["res"].trace == first["res"].trace and again["res"].losses == first["res"].losses,
          "sim (c): the same spec twice on the card gives another trace or other losses")
    mono = run(label, kw, "ho_sgd", "flat", replay="monolithic")
    check(mono["res"].trace == first["res"].trace and mono["res"].comm_bytes == [
        4 * m if o == 0 else 4 * d for o in first["res"].orders],
          "sim (c) monolithic: not the per-worker trace, or not 4*m / 4*d bytes")
    check(all(mono["launches"].get(n, 0) > 0 for n in FUSED_PAIR),
          f"sim (c) monolithic: the fused pair was not launched ({mono['launches']})")
    print(f"  sim (c) twice on flat: trace and losses bit for bit; monolithic replay: the same "
          f"trace, host wall ms per call " + ", ".join(
              f"{k} {v:.2f}" for k, v in medians(mono["probe"]).items()) + f" [{smi}]")
    # the control: the fused commit's reconstruction zeroed, on (a) HO-SGD
    real = ops.zo_reconstruct_update
    ops.zo_reconstruct_update = lambda p, mom, *a, **k: (p, mom)
    try:
        ctrl = run("a control", {}, "ho_sgd", "flat", shadow=True)
    finally:
        ops.zo_reconstruct_update = real
    check(ctrl["probe"].worst > 0.02, "sim control: a zeroed reconstruction passes the ZO check")
    print(f"  control: zo_reconstruct_update's commit zeroed on (a) HO-SGD: ZO calls "
          f"{ctrl['probe'].worst:.2e} of tree's change off, rejected")
    return by_path


# --------------------------------------------------------------------------- #
# phase 8f: open-loop serving traffic on qwen3-14b at full width
# --------------------------------------------------------------------------- #
TRAFFIC_PATH = "traffic qwen3-14b --reduce full poisson:50.0,mixed"
TRAFFIC_ARGV = ["--arch", "qwen3-14b", "--reduce", "full", "--traffic", "poisson:50.0,mixed",
                "--requests", "32", "--slots", "8"]


def traffic_phase(torch, dev, argv=TRAFFIC_ARGV):
    """``launch.serve.main`` with ``--traffic poisson:50.0,mixed`` (the
    reference's help example) on qwen3-14b at full width and depth, 32
    requests, 8 slots: flash launches, all ``wgmma``; the CSV and the trace
    against the result; a second replay on the same weights gives the same
    events, rows and summary; the token-independent part of the summary
    and rows equals ``replay_seed_sync``'s; the replay's wall time, decode
    steps and their device-clock time (CUDA events around each step)."""
    import csv
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import variant as fa_variant
    from repro_torch.launch import serve as serve_cli
    from repro_torch.obs import load_trace_events
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.sim.traffic import replay, replay_seed_sync, serve_compute_model

    made = []
    init = serve_cli.T.init_model

    def keep(gen, cfg, device):
        params = init(gen, cfg, device=device)
        made.append((cfg, params))
        return params

    smi = smi_line()
    with tempfile.TemporaryDirectory() as tmp:
        log, trace = str(Path(tmp) / "rows.csv"), str(Path(tmp) / "trace.json")
        serve_cli.T.init_model = keep
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = serve_cli.main(argv + ["--log", log, "--trace", trace])
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            serve_cli.T.init_model = init
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        with open(log) as f:
            rows = list(csv.DictReader(f))
        n_spans = sum(1 for e in load_trace_events(trace) if e.get("ph") == "X")
    (cfg, params), = made
    full = cfg == get_config("qwen3-14b").with_(use_pallas=True)
    check(cfg.use_pallas and full == ("full" in argv),
          f"traffic: {cfg.name} is not what {argv} asks for, or use_pallas is off")
    variant = fa_variant(getattr(torch, cfg.dtype), cfg.head_dim)
    check(launches.get("flash_attention", 0) > 0 and
          launches.get(f"flash_attention_{variant}", 0) == launches["flash_attention"],
          f"traffic: flash launches {launches}, expected > 0, all {variant}")
    check(len(rows) == len(res.rows) and all(
        float(r[k]) == row[k] for r, row in zip(rows, res.rows) for k in row),
          "traffic: the CSV's rows are not the result's")
    check(n_spans == 3 * len(res.rows) - sum(1 for e in res.events
                                             if e[0] == "done" and e[2] == "prefill"),
          f"traffic: {n_spans} spans in the trace")
    spec = serve_cli.parse_traffic(argv[argv.index("--traffic") + 1], 32, 0, cfg.vocab_size)
    cm = serve_compute_model(cfg, 1e12)
    # the same spec again on the same weights, each decode step timed by
    # CUDA events on the card's clock
    eng = Engine(cfg, params, ServeConfig(max_seq=spec.required_max_seq(), slots=8))
    decode, ev = eng.scheduler._decode, []

    def timed(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        outp = decode(*args)
        e.record()
        ev.append((s, e))
        return outp

    eng.scheduler._decode = timed
    ops.reset_launch_counts()
    again = replay(eng, spec, cm)
    torch.cuda.synchronize()
    launches2 = {k: v for k, v in ops.launch_counts().items() if v}
    check((again.events, again.rows, again.summary) == (res.events, res.rows, res.summary),
          "traffic: a second replay of the same spec gives other events, rows or summary")
    sync = replay_seed_sync(spec, cm, batch=8)
    keys = ("rid", "arrival", "prompt_len", "max_new")
    check(res.summary["n_requests"] == sync.summary["n_requests"]
          and res.summary["total_tokens"] == sync.summary["total_tokens"]
          and [[r[k] for k in keys] for r in res.rows] == [[r[k] for k in keys]
                                                          for r in sync.rows],
          "traffic: requests, tokens or arrivals differ from replay_seed_sync's")
    dec_ms = [s.elapsed_time(e) for s, e in ev]
    n_dec = sum(1 for e in res.events if e[0] == "decode")
    check(len(dec_ms) == n_dec, f"traffic: {len(dec_ms)} timed decode steps, {n_dec} events")
    buckets = sorted({e[3] for e in res.events if e[0] == "prefill"})
    s = res.summary
    print(f"  {cfg.name} ({'full width' if full else 'reduced'}, {cfg.dtype}), {spec.rate} "
          f"requests/s (mixed), 32 requests, 8 slots: main() "
          f"{total:.1f} s (weights included), replay wall {res.wall_s:.2f} s, again "
          f"{again.wall_s:.2f} s [{smi}]; prefill buckets {buckets}; flash launches {launches} "
          f"(again {launches2}); {n_dec} decode steps, device-clock ms per step (CUDA events, "
          f"idle gaps included) median {statistics.median(dec_ms):.2f}, sum "
          f"{sum(dec_ms):.1f}; events, rows and summary identical on the second replay")
    print(f"  simulated (FLOP model at 1e12 FLOP/s, not card time): {s['tok_per_sec']:.1f} tok/s,"
          f" TTFT p50 {s['p50_ttft_s'] * 1e3:.1f} ms p99 {s['p99_ttft_s'] * 1e3:.1f} ms, makespan "
          f"{s['makespan_s']:.3f} s; seed-sync baseline {sync.summary['tok_per_sec']:.1f} tok/s")
    del made, params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": res.wall_s, "decode_steps": n_dec,
            "decode_ms": statistics.median(dec_ms)}


# --------------------------------------------------------------------------- #
# phase 9: flash attention against its plain version
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


def flash_ops_ms(ops_: float, dtype_bytes: int) -> float:
    """The products' least time by the inputs' type: bf16 at the dense bf16
    rate, float32 as three TF32 products on the tensor cores (one product
    on the float32 pipes is always slower: 1/67 > 3/495)."""
    if dtype_bytes == 2:
        return ops_ / BF16_OPS_PER_S * 1e3
    return 3 * ops_ / TF32_OPS_PER_S * 1e3


def flash_bound(B, Sq, Sk, H, KV, hd, dtype_bytes, causal, window):
    """(bound ms, by): bytes of q, k, v read once and out written once over
    the HBM rate; the products' operations (2 * hd for q.k and 2 * hd for
    p.v per live pair and head) at the rate of the inputs' type
    (``flash_ops_ms``)."""
    from repro_torch.launch.dryrun import live_pairs    # the pairs the masks keep

    n_bytes = (2 * B * Sq * H + 2 * B * Sk * KV) * hd * dtype_bytes
    ops_ = 4 * hd * H * B * live_pairs(Sq, Sk, causal, window)
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, flash_ops_ms(ops_, dtype_bytes)
    return ((tb, "bytes") if tb >= to else (to, "operations")), n_bytes, ops_


def faulty_attention(torch, q, k, v, fault):
    """Causal attention in plain PyTorch on the card with one of the
    kernels' roundings done wrong, the controls that show the check guards
    it.  ``"p_bf16"``: the bf16 kernel's probabilities rounded to bf16 once,
    not split into two halves.  ``"s_tf32x2"`` / ``"pv_tf32x2"``: the float32
    kernel's S or P.V as two TF32 products (hi*hi + hi*lo, hi = tf32(x)
    rounded to nearest, lo = tf32(x - hi)) instead of three, the other
    product as three; each summed in float32."""
    def tf32(x):                            # cvt.rna.tf32.f32 on the bits
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    def product(eq, a, b, what):
        if q.dtype == torch.bfloat16:       # the bf16 kernel: products in float32
            if what == "pv" and fault == "p_bf16":
                a = a.to(torch.bfloat16)
            return torch.einsum(eq, a.float(), b.float())
        ah, bh = tf32(a), tf32(b)           # the float32 kernel: three TF32 products
        pairs = [(ah, bh), (ah, tf32(b - bh)), (tf32(a - ah), bh)]
        return sum(torch.einsum(eq, x, y)
                   for x, y in pairs[:2 if fault == what + "_tf32x2" else 3])

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    s = product("bqgrd,bkgd->bgrqk", q.reshape(B, Sq, KV, H // KV, hd), k, "s") * (1.0 / hd ** 0.5)
    keep = (torch.arange(Sq, device=q.device)[:, None]
            >= torch.arange(Sk, device=q.device)[None, :])
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = product("bgrqk,bkgd->bgrqd", p, v, "pv") / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def time_flash(torch, q, k, v, causal=True):
    """Kernel, plain and SDPA times (in turns) of one attention call on the
    card, with the bound and the rates, printed; the row for the JSON."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, H, hd = q.shape
    KV = k.shape[2]
    dtype_bytes = q.element_size()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kern = lambda: fa.flash_attention(q, k, v, causal)                      # noqa: E731
    plain = lambda: ref.ref_flash_attention(q, k, v, causal)                # noqa: E731
    lib = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)       # noqa: E731
    lib_err = float((lib().transpose(1, 2).float() - plain().float()).abs().max())
    p1, k1, l1 = cuda_ms(torch, plain), cuda_ms(torch, kern), cuda_ms(torch, lib)
    l2, k2, p2 = cuda_ms(torch, lib), cuda_ms(torch, kern), cuda_ms(torch, plain)
    (b, by), n_bytes, n_ops = flash_bound(B, S, S, H, KV, hd, dtype_bytes, causal, None)
    row = {"S": S, "H": H, "KV": KV, "hd": hd, "causal": causal,
           "variant": fa.variant(q.dtype, hd), "ms": (k1 + k2) / 2,
           "plain_ms": (p1 + p2) / 2, "library_ms": (l1 + l2) / 2, "bound_ms": b,
           "bound_by": by, "bytes": n_bytes, "operations": n_ops}
    if dtype_bytes == 2:
        ops_text = f"at {BF16_OPS_PER_S / 1e12:.0f} T/s {flash_ops_ms(n_ops, 2):.5f}"
        issued = f"{1.5 * n_ops / row['ms'] / 1e9:.1f} TFLOP/s issued (6 hd per pair: P split)"
    else:
        ops_text = (f"x3 at {TF32_OPS_PER_S / 1e12:.0f} T/s TF32 {flash_ops_ms(n_ops, 4):.5f}, "
                    f"x1 at {FP32_OPS_PER_S / 1e12:.0f} T/s on the float32 pipes "
                    f"{n_ops / FP32_OPS_PER_S * 1e3:.5f}")
        row["tf32_tflops_issued"] = 3 * n_ops / row["ms"] / 1e9
        issued = (f"{row['tf32_tflops_issued']:.1f} TF32 TFLOP/s issued (12 hd per pair: three "
                  f"products) of {TF32_OPS_PER_S / 1e12:.0f}")
    print(f"  flash_attention [{row['variant']}] S={S:5d} H={H} KV={KV} hd={hd} "
          f"{'bf16' if dtype_bytes == 2 else 'float32'}{'' if causal else ' causal off'}:"
          f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} library_ms="
          f"{row['library_ms']:.4f} (scaled_dot_product_attention, max |diff| to plain "
          f"{lib_err:.3e}) bound_ms={b:.5f} ({by}; bytes {n_bytes / HBM_BYTES_PER_S * 1e3:.5f}, "
          f"operations {n_ops:.3e} {ops_text}); kernel at "
          f"{n_ops / row['ms'] / 1e9:.1f} TFLOP/s of the function's work, {issued}, SDPA at "
          f"{n_ops / row['library_ms'] / 1e9:.1f}; bound / kernel {b / row['ms']:.3f}, kernel / "
          f"SDPA {row['ms'] / row['library_ms']:.2f}")
    return row


def hubert_flash_phase(torch, dev, S=1024, H=16, hd=80):
    """Flash attention at hubert-xlarge's widths (head_dim 80, 16 heads, no
    causal mask, B=1), held against the plain version and timed beside SDPA
    and the bound: bf16 on the bf16 kernel, then float32 on the TF32x3
    one.  No served model runs this width yet: the serve runs count its
    launches (``flash_attention_hd80``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(1, S, H, hd, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    got, want = fa.flash_attention(q, k, v, False), ref.ref_flash_attention(q, k, v, False)
    ok, err, tol = attn_agree(torch, got, want)
    print(f"  flash_attention [{fa.variant(q.dtype, hd)}] B=1 S={S} H={H} KV={H} hd={hd} bf16 "
          f"causal off max_abs_err={err:.3e} ({tol})")
    check(ok, f"flash_attention at hd={hd}: kernel and plain version disagree ({err})")
    row = time_flash(torch, q, k, v, causal=False)
    row["max_abs_err"] = err
    # float32 draws: bf16 values have no low TF32 half, so the three products
    # would be exact
    q, k, v = (torch.randn(1, S, H, hd, generator=g).to(dev) for _ in range(3))
    ok, err, tol = attn_agree(torch, fa.flash_attention(q, k, v, False),
                              ref.ref_flash_attention(q, k, v, False))
    print(f"  flash_attention [{fa.variant(q.dtype, hd)}] B=1 S={S} H={H} KV={H} hd={hd} "
          f"float32 causal off max_abs_err={err:.3e} ({tol})")
    check(ok, f"flash_attention at hd={hd} float32: kernel and plain version disagree ({err})")
    row["float32"] = dict(time_flash(torch, q, k, v, causal=False), max_abs_err=err)
    return row


def flash_phase(torch, dev, serve_shapes=SERVE_SHAPES, H=40, KV=8, hd=128):
    """Each variant of the kernel against the plain version at every head
    width (bf16 on the bf16 kernel, float32 on the TF32x3 one), with
    controls; then times beside the plain version, SDPA and the bound: bf16
    at the serving shape for every S in ``serve_shapes``, float32 at the
    largest."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(11)

    def qkv(S, H_, KV_, hd_, dtype, B=1):
        Sq, Sk = S if isinstance(S, tuple) else (S, S)
        return [torch.randn(B, n_s, n, hd_, generator=g).to(dev, dtype)
                for n_s, n in ((Sq, H_), (Sk, KV_), (Sk, KV_))]

    worst = {"wgmma": 0.0, "tf32x3": 0.0}

    def compare(what, args, causal=True, window=None, softcap=None):
        variant = fa.variant(args[0].dtype, args[0].shape[3])
        before = dict(fa.LAUNCHES)
        got = fa.flash_attention(*args, causal, window, softcap)
        launched = {c: n - before[c] for c, n in fa.LAUNCHES.items() if n != before[c]}
        check(launched == {"flash_attention": 1, f"flash_attention_{variant}": 1,
                           f"flash_attention_hd{args[0].shape[3]}": 1},
              f"flash_attention {what}: not one launch of the {variant} kernel ({launched})")
        want = ref.ref_flash_attention(*args, causal, window, softcap)
        ok, err, tol = attn_agree(torch, got, want)
        print(f"  flash_attention [{variant}] {what:52s} max_abs_err={err:.3e} ({tol})")
        check(ok, f"flash_attention {what}: kernel and plain version disagree ({err})")
        worst[variant] = max(worst[variant], err)
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
        if S == serve_shapes[-1]:
            control(f"probabilities rounded to bf16 once, not split (S={S})",
                    faulty_attention(torch, *inputs[S], "p_bf16"), want)
    moe_qkv = qkv(1024, 64, 4, 128, bf)         # qwen3-moe-235b-a22b: 16 query heads per KV head
    compare("qwen3-moe S=1024 H=64 KV=4 hd=128 bf16 causal", moe_qkv)
    compare("gemma2 S=4608 H=8 KV=4 hd=256 bf16 window=4096 softcap=50",
            qkv(4608, 8, 4, 256, bf), window=4096, softcap=50.0)
    compare("phi3 S=512 H=32 KV=32 hd=96 bf16", qkv(512, 32, 32, 96, bf))
    compare("S=512 H=8 KV=2 hd=128 bf16 causal off", qkv(512, 8, 2, 128, bf), causal=False)
    compare("S=256 H=8 KV=2 hd=64 bf16 B=2", qkv(256, 8, 2, 64, bf, B=2))
    compare("S=256 H=4 KV=2 hd=32 bf16 window=8", qkv(256, 4, 2, 32, bf), window=8)
    compare("S=576 H=8 KV=2 hd=128 bf16 (tile half past Sq)", qkv(576, 8, 2, 128, bf))
    compare("S=64 H=4 KV=1 hd=256 bf16 (tile half past Sq)", qkv(64, 4, 1, 256, bf))
    compare("Sq=128 Sk=512 H=8 KV=2 hd=128 bf16 causal", qkv((128, 512), 8, 2, 128, bf, B=2))
    compare("Sq=128 Sk=512 H=8 KV=2 hd=128 bf16 causal off", qkv((128, 512), 8, 2, 128, bf, B=2),
            causal=False)
    compare("Sq=512 Sk=128 H=4 KV=4 hd=96 bf16 causal", qkv((512, 128), 4, 4, 96, bf))
    S = serve_shapes[-1]
    f32 = qkv(S, H, KV, hd, torch.float32)    # float32 draws: bf16 values have no TF32 low half
    want = compare(f"serving S={S} H={H} KV={KV} hd={hd} float32 causal", f32)
    for drop in ("s", "pv"):
        control(f"float32 {'S' if drop == 's' else 'P.V'} with two TF32 products, not three "
                f"(S={S})", faulty_attention(torch, *f32, f"{drop}_tf32x2"), want)
    # rows of 4096 keys and no causal mask: a small largest value, so the
    # tightest float32 tolerance, where O summed in place in the tensor
    # cores' accumulator (which truncates) would drift past it
    compare("S=4096 H=8 KV=8 hd=128 float32 causal off", qkv(4096, 8, 8, 128, torch.float32),
            causal=False)
    compare("gemma2 S=4608 H=8 KV=4 hd=256 float32 window=4096 softcap=50",
            qkv(4608, 8, 4, 256, torch.float32), window=4096, softcap=50.0)
    compare("S=512 H=8 KV=2 hd=64 float32", qkv(512, 8, 2, 64, torch.float32))
    compare("S=256 H=8 KV=2 hd=128 float32 window=100 softcap=30 B=2",
            qkv(256, 8, 2, 128, torch.float32, B=2), window=100, softcap=30.0)
    compare("Sq=128 Sk=512 H=4 KV=2 hd=96 float32 causal", qkv((128, 512), 4, 2, 96, torch.float32))
    for dt_ in (bf, torch.float32):      # hubert-xlarge's head width, both variants
        name = "bf16" if dt_ == bf else "float32"
        compare(f"S=512 H=16 KV=16 hd=80 {name} causal off", qkv(512, 16, 16, 80, dt_),
                causal=False)
        compare(f"S=192 H=8 KV=2 hd=80 {name} causal", qkv(192, 8, 2, 80, dt_))
        compare(f"B=1100 S=64 H=64 KV=8 hd=32 {name} (B*H = 70400 > 65535)",
                qkv(64, 64, 8, 32, dt_, B=1100))
    torch.cuda.synchronize()
    print(f"  launches per variant in these checks: {fa.LAUNCHES}")

    print(f"  times on {smi_line()}:")
    rows = [time_flash(torch, *inputs[S]) for S in serve_shapes]
    float32 = time_flash(torch, *f32)
    return {"max_abs_err": worst["wgmma"], "float32_max_abs_err": worst["tf32x3"], "rows": rows,
            "float32": float32, "qwen3_moe": time_flash(torch, *moe_qkv)}


# --------------------------------------------------------------------------- #
# phase 10: serving qwen3-14b through the port
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


def model_text(cfg):
    """(shape, per-slot cache) of ``cfg`` as text, for the log."""
    shape, cache = [], []
    if cfg.has_attention:
        shape.append(f"heads {cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.head_dim}")
        cache.append(f"KV cache {2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2:,} B "
                     f"per token and slot")
    if cfg.has_ssm:
        state = cfg.n_layers * cfg.d_inner * ((cfg.ssm_conv - 1) * 2 + cfg.ssm_state * 4)
        shape.append(f"d_inner {cfg.d_inner}, state {cfg.ssm_state}, conv {cfg.ssm_conv}, "
                     f"dt_rank {cfg.dt_rank_actual}")
        cache.append(f"conv + ssm state {state:,} B per slot")
    if cfg.is_moe:
        shape.append(f"{cfg.n_experts} experts, top-{cfg.top_k}, expert d_ff {cfg.d_ff}")
    elif cfg.d_ff:
        shape.append(f"d_ff {cfg.d_ff}")
    return ", ".join(shape + [f"vocab {cfg.vocab_size}", cfg.dtype]), "; ".join(cache)


def leaf_count(cfg) -> int:
    """Parameters of ``init_model(cfg)``: ``param_count()`` (the reference's,
    copied) plus the float32 leaves it leaves out, a hybrid's two output
    scales per layer and layernorm's biases."""
    n = 2 * cfg.d_model * cfg.n_layers if cfg.arch_type == "hybrid" else 0
    if cfg.norm == "layernorm":
        n += cfg.d_model * (2 * cfg.n_layers + 1)
    return cfg.param_count() + n


def serve_phase(torch, dev, cfg=None, lens=None, max_new=32, slots=8,
                kernel="flash_attention", probe=None):
    """qwen3-14b (full width and depth unless ``cfg`` is given) served twice
    on the same weights: through ``kernel`` (``use_pallas``) and through the
    plain path; ``probe(use_pallas)``, when given, is a context manager
    around each run's ``generate``.  Returns both runs' launch counts and
    the parameters."""
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
    shape, cache = model_text(cfg)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {shape}: "
          f"{n_params:,} parameters ({n_params * 2 / 1e9:.1f} GB), initialised on the card "
          f"in {time.perf_counter() - t0:.1f} s; {cache}")
    check(n_params == leaf_count(cfg), f"{n_params} parameters, param_count() and the "
          f"leaves it leaves out say {leaf_count(cfg)}")

    rng = np.random.default_rng(0)
    lens = lens or [65, 1000] + [int(n) for n in rng.integers(65, 1001, 6)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in lens]
    # the largest bucket fits (an SSM prefills at exact length)
    max_seq = (max(lens) if cfg.has_ssm else 1 << (max(lens) - 1).bit_length()) + max_new
    print(f"  {len(prompts)} prompts of {lens} tokens, {max_new} new tokens each, "
          f"{slots} slots, max_seq {max_seq}")

    runs = {}
    for use_pallas in (True, False):
        eng = Engine(cfg.with_(use_pallas=use_pallas), params,
                     ServeConfig(max_seq=max_seq, slots=slots))
        rec = {"prefill": [], "decode_ms": [], "margins": {}}
        instrument(torch, eng.scheduler, rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with probe(use_pallas) if probe else contextlib.nullcontext():
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
    print(f"  launches: kernel run {fast['launches'][kernel]} "
          f"(prefills on 64-aligned buckets {len(kernel_buckets)} x {cfg.n_layers} layers "
          f"= {want_launches}), plain run {plain['launches'][kernel]}")
    check(fast["launches"][kernel] == want_launches == n_prefill * cfg.n_layers,
          f"{kernel} launches != admitted prefills x layers")
    check(plain["launches"][kernel] == 0, "the plain run launched the kernel")
    flash = {k[len("flash_attention_"):]: n for k, n in fast["launches"].items()
             if k.startswith("flash_attention_")}
    print(f"  flash launches of the kernel run by variant and by head width: {flash}")
    if kernel == "flash_attention":
        check(flash["wgmma"] == flash[f"hd{cfg.head_dim}"] == fast["launches"][kernel],
              f"not every serving flash launch ran the bf16 tensor-core kernel at "
              f"hd={cfg.head_dim}")

    # last-prompt-token logits of the two runs
    top = max(float(lg.abs().max()) for _, _, lg, _ in plain["prefill"])
    tol = 0.05 * top
    diffs = [float((a[2] - b[2]).abs().max()) for a, b in zip(fast["prefill"], plain["prefill"])]
    print(f"  last-prompt-token logits, kernel vs plain run: max |diff| {max(diffs):.4f} "
          f"(per prompt {[round(d, 4) for d in diffs]}); tolerance 5% of the largest "
          f"logit {top:.3f} = {tol:.4f} (both paths round each {ROUNDED[kernel]} to bf16 "
          f"from float32 sums in other orders; a flipped rounding is 2**-8 of a value and "
          f"spreads through every later bf16 operation of {cfg.n_layers} layers"
          f"{': two layers already differ by ~0.7%' if kernel == 'flash_attention' else ''})")
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
    return {"launches": fast["launches"], "plain_launches": plain["launches"],
            "params": params, "prompts": prompts, "cfg": cfg,
            "decode_ms": {name: statistics.median(rec["decode_ms"])
                          for name, rec in (("kernel", fast), ("plain", plain))}}


def profile_call(torch, what, fn, key="flash_fwd", label="flash kernel", after_warmup=None):
    """torch.profiler over one call of ``fn`` (after one warm-up call, then
    ``after_warmup()``): host wall, device busy and idle share, device
    kernels launched, and device time by kernel, with the share of the
    kernels whose name holds ``key``.  Returns the device busy ms (None when
    the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    if after_warmup is not None:
        after_warmup()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print(f"  {what}: not measured (the profiler saw no device time)")
        return None
    busy = sum(r[0] for r in rows) / 1e3
    flash = sum(r[0] for r in rows if key in r[2]) / 1e3
    print(f"  {what} under the profiler: host wall {1e3 * wall:.3f} ms, device busy "
          f"{busy:.3f} ms (idle share {1 - busy / (1e3 * wall):.3f}), "
          f"{sum(r[1] for r in rows)} device kernels and copies; {label} "
          f"{flash:.3f} ms = {flash / busy:.3f} of device time")
    for us, count, name in sorted(rows, reverse=True)[:8]:
        print(f"    {us / 1e3:9.3f} ms  {count:5d} calls  {name[:90]}")
    return busy


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


# --------------------------------------------------------------------------- #
# phase 11: the selective scan and RMSNorm against their plain versions
# --------------------------------------------------------------------------- #
def max_agree(torch, got, want, rel=1e-4, of="y"):
    """(ok, max abs error, tolerance text): float32 within ``rel`` of the
    largest |want|; bf16 within one bf16 ulp per element, where values under
    1e-3 of the largest count as 1e-3 of it (both sides compute in float32,
    the sums in other orders, and round once)."""
    got32, want32 = got.float(), want.float()
    err = (got32 - want32).abs()
    top = want32.abs().max()
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(want32.abs(), 1e-3 * top))
        ok = bool((err <= torch.ldexp(torch.ones_like(want32), e - 8)).all())
        return ok, float(err.max()), "1 bf16 ulp each (floor 1e-3 of max)"
    return (bool((err <= rel * top).all()), float(err.max()),
            f"{rel:g}*max|{of}| = {float(rel * top):.3e}")


def scan_inputs(torch, dev, B, S, di, n, dtype, seed=0):
    """The reference test's distributions: u ~ 0.5 N, dt = 0.1 softplus(N),
    B and C ~ N, A = -exp(0.2 N), D = 1; A and D float32."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)   # noqa: E731
    u, dt = 0.5 * r(B, S, di), 0.1 * torch.nn.functional.softplus(r(B, S, di))
    Bm, Cm, A = r(B, S, n), r(B, S, n), -torch.exp(0.2 * r(di, n))
    return [t.to(dev, dtype) for t in (u, dt, Bm, Cm)] + [A.to(dev), torch.ones(di, device=dev)]


def faulty_scan(torch, u, dt, Bm, Cm, A, D, fault, tile):
    """The plain recurrence with one fault: ``reset`` (h = 0 at every tile
    of ``tile`` steps), ``no_du`` (the D u term dropped) or ``c_late``
    (C_{t-1} read at step t, zeros at t = 0)."""
    uf, dtf, Bf, Cf = (t.float() for t in (u, dt, Bm, Cm))
    h = torch.zeros((u.shape[0], u.shape[2], A.shape[1]), device=u.device)
    ys = []
    for t in range(u.shape[1]):
        if fault == "reset" and t % tile == 0:
            h = torch.zeros_like(h)
        h = torch.exp(dtf[:, t, :, None] * A) * h + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None]
        if fault == "c_late":
            C = Cf[:, t - 1] if t else torch.zeros_like(Cf[:, 0])
        else:
            C = Cf[:, t]
        ys.append((h * C[:, None]).sum(-1) + (0 if fault == "no_du" else D * uf[:, t]))
    return torch.stack(ys, 1).to(u.dtype)


def scan_bound(S, di, n, exp_instr, B=1, dtype_bytes=4):
    """(bound ms, by), bytes, instructions: u and dt read and y written
    (B, S, di), B and C read (B, S, n), A and D read, the float32 final
    state written (B, di, n); one expf plus six
    multiplies and adds per (t, d, s) (dt*A, dA*h, dtu*B, +, h*C, + into the
    sum) and two more per (t, d) (dt*u, D*u and its add, less the first
    add of the sum), over the issue rate."""
    n_bytes = (3 * B * S * di + 2 * B * S * n) * dtype_bytes + (di * n + di + B * di * n) * 4
    n_instr = B * S * di * (n * (exp_instr + 6) + 2)
    return bound_ms(n_bytes, n_instr), n_bytes, n_instr


def scan_phase(torch, dev, exp_instr, tile, di=8192, n=16, shapes=SCAN_SHAPES,
               big_b=(70000, 3, 8, 16), margin=0.05):
    """The kernel's y and final state against the plain version's (the
    served width at every S of ``shapes``, bf16, ragged S and di, every n
    template, n past 64 in groups, a B past 65535), with controls (the
    state reset every ``tile`` steps, the served template's tile); then each
    n = 16 lane variant held and timed at every S, in turns, beside the
    plain version and the bound.  Fails if, at the longest S, another
    variant beats the served one (``SERVED_LANES``) by more than ``margin``
    of its time; a smaller lead is flagged."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    worst = {"y": 0.0, "h": 0.0}

    def compare(what, args, lanes=None):
        got, h = ss.selective_scan(*args, return_state=True, _lanes=lanes)
        want, h_want = ref.ref_selective_scan(*args, return_state=True)
        ok, err, tol = max_agree(torch, got, want)
        ok_h, err_h, tol_h = max_agree(torch, h, h_want, rel=1e-5, of="h")
        print(f"  selective_scan {what:48s} y max_abs_err={err:.3e} ({tol}); final state "
              f"max_abs_err={err_h:.3e} ({tol_h})")
        check(ok, f"selective_scan {what}: kernel and plain version disagree ({err})")
        check(ok_h, f"selective_scan {what}: final states disagree ({err_h})")
        check(tuple(h.shape) == tuple(h_want.shape) and h.dtype == torch.float32,
              f"selective_scan {what}: final state of shape {tuple(h.shape)}, {h.dtype}")
        worst["y"], worst["h"] = max(worst["y"], err), max(worst["h"], err_h)
        return want, h_want

    inputs = {S: scan_inputs(torch, dev, 1, S, di, n, torch.float32, seed=S) for S in shapes}
    for S in shapes:
        want, h_want = compare(f"B=1 S={S} di={di} n={n} float32", inputs[S])
        if S == shapes[1]:
            for fault, text in (("reset", f"state reset every {tile}-step tile"),
                                ("no_du", "D*u dropped"), ("c_late", "C_t read one step late")):
                bad = faulty_scan(torch, *inputs[S], fault, tile)
                ok, err, _ = max_agree(torch, bad, want)
                print(f"  selective_scan control, {text}: fails the check (max_abs_err={err:.3e})")
                check(not ok, f"selective_scan: the check lets a faulty output pass ({text})")
            early = ref.ref_selective_scan(*(t[:, :-1] for t in inputs[S][:4]), *inputs[S][4:],
                                           return_state=True)[1]
            ok, err, _ = max_agree(torch, early, h_want, rel=1e-5)
            print(f"  selective_scan control, final state one step early: fails the check "
                  f"(max_abs_err={err:.3e})")
            check(not ok, "selective_scan: the state check lets a state one step early pass")
    compare(f"B=1 S=256 di={di} n={n} bf16", scan_inputs(torch, dev, 1, 256, di, n, torch.bfloat16))
    for B, S, d_, n_ in ((2, 100, 200, 16), (2, 33, 64, 4), (1, 40, 96, 8), (1, 70, 64, 24),
                         (1, 37, 64, 64), (1, 50, 72, 96), (2, 33, 64, 128), (3, 1, 8192, 16),
                         big_b):
        for dt_ in (torch.float32, torch.bfloat16):
            compare(f"B={B} S={S} di={d_} n={n_} {str(dt_)[6:]}",
                    scan_inputs(torch, dev, B, S, d_, n_, dt_))
    for lanes in ss.LANES:
        compare(f"B=2 S=130 di=200 n=16 float32, {lanes} lanes",
                scan_inputs(torch, dev, 2, 130, 200, 16, torch.float32), lanes=lanes)
    torch.cuda.synchronize()

    rows = []
    for S in shapes:
        args = inputs[S]
        for lanes in ss.LANES:
            compare(f"B=1 S={S} di={di} n={n} float32, {lanes} lanes", args, lanes=lanes)
        plain = lambda: ref.ref_selective_scan(*args)  # noqa: E731
        kern = {L: (lambda L=L: ss.selective_scan(*args, return_state=True, _lanes=L))
                for L in ss.LANES}
        p1 = cuda_ms(torch, plain, reps=5)
        t1 = {L: cuda_ms(torch, kern[L]) for L in ss.LANES}            # in turns:
        t2 = {L: cuda_ms(torch, kern[L]) for L in reversed(ss.LANES)}  # plain, 2 4 8 8 4 2, plain
        p2 = cuda_ms(torch, plain, reps=5)
        by_lanes = {L: (t1[L] + t2[L]) / 2 for L in ss.LANES}
        (b, by), n_bytes, n_instr = scan_bound(S, di, n, exp_instr)
        fastest = min(by_lanes, key=by_lanes.get)
        row = {"S": S, "ms": by_lanes[ss.SERVED_LANES], "plain_ms": (p1 + p2) / 2,
               "library_ms": None, "bound_ms": b, "bound_by": by,
               "ms_by_lanes": {str(L): t for L, t in by_lanes.items()}, "fastest_lanes": fastest}
        rows.append(row)
        print(f"  selective_scan S={S:5d} (final state written): ms by lanes per channel "
              f"{ {L: round(t, 5) for L, t in by_lanes.items()} } (fastest {fastest}, the "
              f"dispatch serves {ss.SERVED_LANES}); plain_ms={row['plain_ms']:.3f} "
              f"bound_ms={b:.5f} ({by}; bytes {n_bytes / HBM_BYTES_PER_S * 1e3:.5f}, "
              f"{n_instr:.3e} instructions {n_instr / INSTR_PER_S * 1e3:.5f}); served "
              f"kernel at {b / row['ms']:.3f} of its bound; no library call computes the scan")
    head = rows[-1]
    lead = head["ms"] / by_lanes[head["fastest_lanes"]] - 1
    if head["fastest_lanes"] != ss.SERVED_LANES:
        print(f"  WARNING selective_scan S={head['S']}: {head['fastest_lanes']} lanes per "
              f"channel beat the served {ss.SERVED_LANES} by {lead:.3%} of its time")
    check(lead <= margin, f"selective_scan: the dispatch serves {ss.SERVED_LANES} lanes, "
          f"{head['fastest_lanes']} are faster by {lead:.3%} at S={head['S']} (over {margin:.0%})")
    return {"max_abs_err": worst["y"], "state_max_abs_err": worst["h"], "rows": rows}


def rmsnorm_phase(torch, dev, shapes=((1024, 4096, "bfloat16"), (1000, 5120, "float32"),
                                      (1024, 12288, "bfloat16"))):
    """The kernel against its plain version (timed shapes and ragged ones,
    rows wider than 8192 on the second shape), with controls; times beside
    ``F.rms_norm`` and the bound; then the path
    (``ops.rmsnorm`` on any leading shape) with its launches counted."""
    from torch.nn.functional import rms_norm

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator().manual_seed(3)

    def inputs(R, D, dtype):
        x = torch.randn(R, D, generator=g).to(dev, getattr(torch, dtype))
        return x, (0.1 * torch.randn(D, generator=g)).to(dev)

    worst = 0.0
    for R, D, dt_ in shapes + ((3, 8192, "float32"), (5, 1, "bfloat16"), (7, 333, "bfloat16"),
                               (1, 8192, "bfloat16"), (2, 4097, "float32"), (9, 1004, "bfloat16"),
                               (8192, 128, "bfloat16"), (4, 8192, "float32"),
                               (4, 8193, "bfloat16"), (5, 8193, "float32"),
                               (3, 12288, "float32"), (2, 16384, "bfloat16")):
        x, s = inputs(R, D, dt_)
        got, want = rn.rmsnorm(x, s, 1e-6), ref.ref_rmsnorm(x, s, 1e-6)
        ok, err, tol = max_agree(torch, got, want)
        print(f"  rmsnorm R={R} D={D} {dt_:8s} max_abs_err={err:.3e} ({tol})")
        check(ok, f"rmsnorm R={R} D={D} {dt_}: kernel and plain version disagree ({err})")
        worst = max(worst, err)
        if (R, D) == shapes[0][:2]:
            xf = x.float()
            for text, bad in (("(1 + scale) dropped", ref.ref_rmsnorm(x, torch.zeros_like(s))),
                              ("mean over all rows", (xf * torch.rsqrt((xf * xf).mean() + 1e-6)
                                                      * (1 + s)).to(x.dtype))):
                ok, err, _ = max_agree(torch, bad, want)
                print(f"  rmsnorm control, {text}: fails the check (max_abs_err={err:.3e})")
                check(not ok, f"rmsnorm: the check lets a faulty output pass ({text})")
    torch.cuda.synchronize()

    rows = []
    for R, D, dt_ in shapes:
        x, s = inputs(R, D, dt_)
        kern = lambda: rn.rmsnorm(x, s, 1e-6)                       # noqa: E731
        plain = lambda: ref.ref_rmsnorm(x, s, 1e-6)                 # noqa: E731
        lib = lambda: rms_norm(x.float(), (D,), 1 + s, 1e-6)        # noqa: E731
        lib_err = float((lib() - plain().float()).abs().max())
        p1, k1, l1 = cuda_ms(torch, plain), cuda_ms(torch, kern), cuda_ms(torch, lib)
        l2, k2, p2 = cuda_ms(torch, lib), cuda_ms(torch, kern), cuda_ms(torch, plain)
        n_bytes = 2 * R * D * x.element_size() + 4 * D
        n_ops = 5 * R * D      # x*x, its add, x*r, 1+s, the product: float32
        tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
        b, by = (tb, "bytes") if tb >= to else (to, "operations")
        row = {"shape": f"R={R} D={D} {dt_}", "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
               "library_ms": (l1 + l2) / 2, "bound_ms": b, "bound_by": by}
        rows.append(row)
        print(f"  rmsnorm {row['shape']}: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} (F.rms_norm in float32, max |diff| to "
              f"plain {lib_err:.3e}) bound_ms={b:.5f} ({by}; {n_bytes:,} bytes); kernel / "
              f"F.rms_norm {row['ms'] / row['library_ms']:.3f}, kernel / bound "
              f"{row['ms'] / b:.3f}")

    # the path: the public wrapper on a (batch, seq, D) tensor and on each timed shape
    xs = [inputs(R, D, dt_) for R, D, dt_ in shapes]
    x3 = torch.randn(8, 128, 4096, generator=g).to(dev, torch.bfloat16)
    s3 = torch.zeros(4096, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = [ops.rmsnorm(x, s) for x, s in xs] + [ops.rmsnorm(x3, s3)]
    torch.cuda.synchronize()
    launches = ops.launch_counts()["rmsnorm"]
    check(launches == len(outs), f"rmsnorm launched {launches} times for {len(outs)} calls")
    check(outs[-1].shape == x3.shape and bool(torch.isfinite(outs[-1].float()).all()),
          "ops.rmsnorm on (8, 128, 4096): wrong shape or non-finite values")
    ok, err, _ = max_agree(torch, outs[-1], ref.ref_rmsnorm(x3, s3))
    check(ok, f"ops.rmsnorm on (8, 128, 4096) disagrees with the plain version ({err})")
    print(f"  rmsnorm path (ops.rmsnorm on {len(outs)} inputs, one (8, 128, 4096) bf16): "
          f"{launches} launches")
    return {"max_abs_err": worst, "rows": rows, "launches": launches}


def mamba_profiles(torch, cfg, params, tokens, slots=8):
    """One prefill of ``tokens`` (exact length, as the scheduler runs it) on
    each path under the profiler, with the scan kernel's share, the plain
    tail-state scan's calls and time (``transformer._mamba_tail_state``,
    CUDA events around each call: none on the kernel path, which takes the
    state from the kernel, one per layer on the plain path) and the peak
    memory above what was allocated before the call; then one decode step
    over a full pool of ``slots`` slots."""
    from repro_torch.models import transformer as T

    dev = params["embed"].device
    toks = torch.tensor([tokens], device=dev)
    last = torch.tensor([len(tokens) - 1], device=dev)
    tail = T._mamba_tail_state
    spans, paths, mem = [], {}, {}

    def timed_tail(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = tail(*args)
        e.record()
        spans.append((s, e))
        return out

    def reset():
        spans.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        mem["base"] = torch.cuda.memory_allocated(dev)

    for use_pallas, name in ((True, "kernel"), (False, "plain")):
        c = cfg.with_(use_pallas=use_pallas)
        T._mamba_tail_state = timed_tail
        try:
            busy = profile_call(torch, f"{name} path: prefill of {len(tokens)} tokens (exact length)",
                                lambda: T.prefill_at(c, params, {"tokens": toks}, last),
                                key="selective_scan_kernel", label="scan kernel",
                                after_warmup=reset)
        finally:
            T._mamba_tail_state = tail
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - mem["base"]) / 2 ** 30
        tail_ms = sum(s.elapsed_time(e) for s, e in spans)
        want = 0 if use_pallas else cfg.n_layers
        check(len(spans) == want, f"{name} path: {len(spans)} tail-state calls in one prefill, "
              f"expected {want}")
        share = f" = {tail_ms / busy:.3f} of device busy" if busy else ""
        print(f"  {name} path: plain tail-state scan {len(spans)} calls (CUDA events), "
              f"{tail_ms:.3f} ms{share}; peak memory of the prefill {peak:.3f} GiB above "
              f"the {mem['base'] / 2 ** 30:.3f} GiB allocated before it")
        paths[name] = {"device_ms": busy, "tail_calls": len(spans), "tail_ms": tail_ms,
                       "peak_gib": peak}
    k, pl = paths["kernel"], paths["plain"]
    if k["device_ms"] and pl["device_ms"]:
        print(f"  prefill of {len(tokens)} tokens: device time {k['device_ms']:.3f} ms through "
              f"the kernel vs {pl['device_ms']:.3f} ms on the plain path "
              f"({pl['device_ms'] / k['device_ms']:.2f}x); peak memory {k['peak_gib']:.3f} vs "
              f"{pl['peak_gib']:.3f} GiB")
    c = cfg.with_(use_pallas=True)
    caches = T.init_caches(c, slots, len(tokens) + 1, getattr(torch, c.dtype), dev)
    cur = torch.arange(slots, device=dev)
    pos = torch.full((slots,), len(tokens), dtype=torch.int32, device=dev)
    profile_call(torch, f"decode step over {slots} slots",
                 lambda: T.decode_step_slots(c, params, cur, pos, caches),
                 key="selective_scan_kernel", label="scan kernel")
    return paths


# --------------------------------------------------------------------------- #
# phases 14-16: the MoE, hybrid and frontend architectures
# --------------------------------------------------------------------------- #
MOE_LAYERS = 4        # qwen3-moe-235b-a22b's depth on one card: 22.4 GB of its 470 GB
MOE_PATH = f"serve qwen3-moe-235b-a22b ({MOE_LAYERS} layers) prefill"
HYMBA_PATH = "serve hymba-1.5b prefill"
FRONTEND_PATHS = {"pixtral-12b": "pixtral-12b forward_logits + loss_fn, S=2048",
                  "hubert-xlarge": "hubert-xlarge forward_logits + loss_fn, S=1024"}
TRAIN_ARCHS = {"arctic-480b": ["--arch", "arctic-480b", "--tau", "3", "--batch", "16",
                               "--seq", "128"],
               "hymba-1.5b": ["--arch", "hymba-1.5b", "--tau", "3", "--batch", "8",
                              "--seq", "128"]}


class RouteRecorder:
    """Wraps ``models.moe.route`` from outside, per run: the expert ids of
    every call that routes more than ``slots`` tokens (the prefills'; a
    decode step routes one token per slot)."""

    def __init__(self, slots):
        self.slots, self.runs = slots, {}

    @contextlib.contextmanager
    def __call__(self, key):
        from repro_torch.models import moe as M

        inner, ids = M.route, self.runs.setdefault(key, [])

        def route(cfg, p, xf):
            out = inner(cfg, p, xf)
            if xf.shape[0] > self.slots:
                ids.append(out[1].clone())
            return out

        M.route = route
        try:
            yield
        finally:
            M.route = inner

    def differing(self, a, b):
        """(routes of run ``a`` whose expert run ``b`` did not pick for the
        same token, routes) over the prefills' layers, pad tokens included."""
        ra, rb = self.runs[a], self.runs[b]
        check(len(ra) == len(rb) > 0, f"{len(ra)} and {len(rb)} routed prefill layers")
        diff = total = 0
        for x, y in zip(ra, rb):
            check(x.shape == y.shape, f"routes of shapes {x.shape} and {y.shape}")
            diff += x.numel() - int((x[:, :, None] == y[:, None, :]).any(-1).sum())
            total += x.numel()
        return diff, total


def split_call(torch, what, fn):
    """One call of ``fn`` (after a warm-up call) with CUDA events around the
    whole call, every attention call, every MoE layer and its expert
    products (``models.moe.experts``): device-clock spans, host gaps
    included.  Dispatch is the MoE layer less its expert products (router,
    top-k, sort, scatter, gather and combine); the rest is embedding, norms
    and the head."""
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M

    spans = {}

    def timed(part, inner):
        def run(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = inner(*a, **kw)
            e.record()
            spans.setdefault(part, []).append((s, e))
            return out
        return run

    fn()
    torch.cuda.synchronize()
    patched = [(A, "attention_prefill", "attention"), (A, "attention_decode", "attention"),
               (M, "moe_forward", "moe"), (M, "experts", "expert products")]
    old = {(mod, name): getattr(mod, name) for mod, name, _ in patched}
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    try:
        for mod, name, part in patched:
            setattr(mod, name, timed(part, old[(mod, name)]))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
    finally:
        for (mod, name), inner in old.items():
            setattr(mod, name, inner)
    total = s.elapsed_time(e)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    parts = {"attention": ms["attention"], "expert products": ms["expert products"],
             "dispatch": ms["moe"] - ms["expert products"]}
    parts["rest"] = total - ms["attention"] - ms["moe"]
    print(f"  {what} by CUDA events: {total:.3f} ms = " + ", ".join(
        f"{k} {v:.3f} ({v / total:.3f})" for k, v in parts.items()))
    return dict(parts, total=total)


def moe_serve_phase(torch, dev, cfg=None, lens=None, max_new=32, slots=8):
    """qwen3-moe-235b-a22b at full width, depth cut to ``MOE_LAYERS``, served
    as phase 10 serves qwen3-14b (kernel and plain path), with each run's
    prefill routes recorded and compared; then one 1000-token prefill and
    one decode step under the profiler and split by CUDA events, and the
    expert weights a decode step reads beside their least time."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import moe_capacity

    cfg = cfg or get_config("qwen3-moe-235b-a22b").with_(n_layers=MOE_LAYERS)
    routes = RouteRecorder(slots)
    run = serve_phase(torch, dev, cfg=cfg, lens=lens, max_new=max_new, slots=slots,
                      probe=routes)
    diff, total = routes.differing(True, False)
    print(f"  routes: {diff} of {total} (token, expert) routes of the kernel run's prefills "
          f"({diff / total:.5f}) went to an expert the plain run did not pick for that token "
          f"(pad tokens included; the attention outputs part by bf16 roundings, and a router "
          f"logit near a tie flips)")
    params, prompts = run["params"], run["prompts"]
    tokens = max(prompts, key=len)
    bucket = 1 << (len(tokens) - 1).bit_length()
    c = cfg.with_(use_pallas=True)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    toks[0, :len(tokens)] = torch.tensor(tokens)
    last = torch.tensor([len(tokens) - 1], device=dev)
    caches = T.init_caches(c, slots, bucket + max_new, getattr(torch, c.dtype), dev)
    cur = torch.arange(slots, device=dev)
    pos = torch.full((slots,), len(tokens), dtype=torch.int32, device=dev)
    prefill = lambda: T.prefill_at(c, params, {"tokens": toks}, last)           # noqa: E731
    decode = lambda: T.decode_step_slots(c, params, cur, pos, caches)           # noqa: E731
    out = {"routes_differing": diff, "routes": total, "decode_ms": run["decode_ms"],
           "launches": run["launches"], "plain_launches": run["plain_launches"]}
    for what, fn in ((f"prefill of {len(tokens)} tokens (bucket {bucket})", prefill),
                     (f"decode step over {slots} slots", decode)):
        out[what.split()[0] + "_busy_ms"] = profile_call(torch, what, fn)
        out[what.split()[0] + "_split"] = split_call(torch, what, fn)
    expert_bytes = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff * 2
    out["decode_expert_bytes"] = expert_bytes
    out["decode_expert_bound_ms"] = expert_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  a decode step computes every expert at capacity {moe_capacity(cfg, slots)} rows: "
          f"it reads all "
          f"{cfg.n_layers} x {cfg.n_experts} x 3 x {cfg.d_model} x {cfg.d_ff} x 2 B = "
          f"{expert_bytes / 1e9:.1f} GB of expert weights, >= "
          f"{out['decode_expert_bound_ms']:.2f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; the "
          f"kernel run's median decode step took {run['decode_ms']['kernel']:.3f} ms "
          f"[{smi_line()}]")
    del run, params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hybrid_serve_phase(torch, dev, cfg=None, lens=None, max_new=32, slots=8):
    """hymba-1.5b at full width and depth served as phase 12 serves
    falcon-mamba-7b (exact-length prefills, the scan kernel against the
    plain path; its attention stays plain in both, since its windows differ
    by layer); then one prefill of the longest prompt on each path with
    its caches held against each other: layer 0 (the same input on both
    paths) k, v and conv equal and the ssm state within 1e-5 of max|h|,
    every layer's leaf within 5% of its largest (the logits' rule)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = cfg or get_config("hymba-1.5b")
    if lens is None:
        rng = np.random.default_rng(2)
        lens = [64, 1024] + [64 * int(k) for k in rng.integers(1, 17, 6)]
    run = serve_phase(torch, dev, cfg=cfg, lens=lens, max_new=max_new, slots=slots,
                      kernel="selective_scan")
    check(run["launches"]["flash_attention"] == run["plain_launches"]["flash_attention"] == 0,
          "hymba's attention reached the flash kernel (its windows differ by layer)")
    params, tokens = run["params"], max(run["prompts"], key=len)
    toks = torch.tensor([tokens], device=dev)
    last = torch.tensor([len(tokens) - 1], device=dev)
    got = {}
    for use_pallas in (True, False):
        ops.reset_launch_counts()
        _, caches = T.prefill_at(cfg.with_(use_pallas=use_pallas), params, {"tokens": toks},
                                 last)
        torch.cuda.synchronize()
        got[use_pallas] = (caches, ops.launch_counts())
    (fast, nf), (plain, npl) = got[True], got[False]
    check(nf["selective_scan"] == cfg.n_layers and nf["flash_attention"] == 0
          and npl["selective_scan"] == npl["flash_attention"] == 0,
          f"hymba prefill launches: kernel path {nf}, plain path {npl}")
    check(sorted(fast) == sorted(plain) == ["conv", "k", "ssm", "v"],
          f"hymba caches {sorted(fast)}, {sorted(plain)}")
    rel = {}
    for name in ("k", "v", "conv", "ssm"):
        a, b = fast[name].float(), plain[name].float()
        check(a.shape == b.shape and fast[name].dtype == plain[name].dtype, f"{name} cache")
        rel[name] = float((a - b).abs().max() / b.abs().max())
        l0 = float((a[0] - b[0]).abs().max() / b[0].abs().max())
        check(l0 <= 1e-5 if name == "ssm" else l0 == 0.0,
              f"hymba layer 0 {name} cache: kernel vs plain path {l0:.3e}")
        check(rel[name] <= 0.05, f"hymba {name} cache: kernel vs plain path {rel[name]:.4f} "
              f"of its largest value")
    print(f"  prefill caches of {len(tokens)} tokens, kernel vs plain path: layer 0's k, v and "
          f"conv equal, its ssm state within 1e-5 of max|h|; every layer, max |diff| / max "
          f"|plain|: " + ", ".join(f"{k} {v:.5f}" for k, v in rel.items()) + " (tolerance 0.05)")
    out = {"launches": run["launches"], "decode_ms": run["decode_ms"], "cache_rel": rel}
    del run, params, fast, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def frontend_batch(torch, cfg, dev, S, seed=0):
    """B=1 inputs of S positions: ``n_patches`` image embeddings before
    S - n_patches tokens (vision), labels -1 on the image and the last
    position; or S features (audio) with a label each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        return {"features": torch.randn(1, S, cfg.d_model, generator=g, device=dev).to(dt),
                "labels": torch.randint(0, cfg.vocab_size, (1, S), generator=g, device=dev)}
    P = cfg.n_patches
    toks = torch.randint(0, cfg.vocab_size, (1, S - P), generator=g, device=dev)
    labels = torch.full((1, S), -1, dtype=torch.int64, device=dev)
    labels[0, P:-1] = toks[0, 1:]
    return {"image_embeds": torch.randn(1, P, cfg.d_model, generator=g, device=dev).to(dt),
            "tokens": toks, "labels": labels}


def frontend_phase(torch, dev, cfgs=None, seqs=None):
    """pixtral-12b (1024 image embeddings and 1024 tokens) and hubert-xlarge
    (1024 features) at full width and depth, bf16, B=1: ``forward_logits``
    and ``loss_fn`` (no autograd) through the flash kernel and through the
    plain path, each after a warm-up call: one flash launch per layer and
    call on the kernel path (bf16 tensor-core kernel, causal for pixtral,
    not for hubert), none on the plain one; logits within 5% of the plain
    path's largest; the losses' relative difference; ms and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    cfgs = cfgs or [get_config("pixtral-12b"), get_config("hubert-xlarge")]
    seqs = seqs or {"pixtral-12b": 2048, "hubert-xlarge": 1024}
    smi = smi_line()
    out = {}
    for cfg in cfgs:
        name = cfg.name.split("-reduced")[0]
        S = seqs[name]
        t0 = time.perf_counter()
        params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(params))
        check(n == leaf_count(cfg), f"{cfg.name}: {n} parameters, expected {leaf_count(cfg)}")
        print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {model_text(cfg)[0]}, "
              f"frontend {cfg.frontend}: {n:,} parameters ({n * 2 / 1e9:.1f} GB), initialised "
              f"on the card in {time.perf_counter() - t0:.1f} s; B=1, S={S}"
              + (f" ({cfg.n_patches} image embeddings + {S - cfg.n_patches} tokens)"
                 if cfg.frontend == "vision" else " features"))
        batch = frontend_batch(torch, cfg, dev, S)
        causal_seen = []
        inner = ops.flash_attention

        def flash(q, k, v, causal=True, *a, **kw):
            causal_seen.append(causal)
            return inner(q, k, v, causal, *a, **kw)

        runs = {}
        ops.flash_attention = flash
        try:
            for use_pallas in (True, False):
                c = cfg.with_(use_pallas=use_pallas)
                rec = {}
                for what, fn in (("forward_logits", lambda: T.forward_logits(c, params, batch)[0]),
                                 ("loss_fn", lambda: T.loss_fn(c, params, batch))):
                    with torch.no_grad():
                        fn()
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats(dev)
                        base = torch.cuda.memory_allocated(dev)
                        causal_seen.clear()
                        ops.reset_launch_counts()
                        t0 = time.perf_counter()
                        val = fn()
                        torch.cuda.synchronize()
                        rec[what] = {"ms": 1e3 * (time.perf_counter() - t0),
                                     "launches": dict(ops.launch_counts()),
                                     "causal": list(causal_seen),
                                     "peak_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9,
                                     "value": val}
                runs[use_pallas] = rec
        finally:
            ops.flash_attention = inner
        fast, plain = runs[True], runs[False]
        hd = cfg.head_dim
        for what in ("forward_logits", "loss_fn"):
            lf, lp = fast[what]["launches"], plain[what]["launches"]
            check(lf["flash_attention"] == lf["flash_attention_wgmma"] == lf[f"flash_attention_hd{hd}"]
                  == cfg.n_layers and fast[what]["causal"] == [not cfg.encoder_only] * cfg.n_layers,
                  f"{cfg.name} {what}: flash launches {lf}, causal {fast[what]['causal'][:3]}...")
            check(lp["flash_attention"] == 0, f"{cfg.name} {what}: the plain path launched flash")
        a, b = fast["forward_logits"]["value"], plain["forward_logits"]["value"]
        check(a.shape == (1, S, cfg.vocab_size) and bool(torch.isfinite(a).all()),
              f"{cfg.name}: logits of shape {tuple(a.shape)}, or not finite")
        top = float(b.abs().max())
        err = max(float((a[:, i:i + 256].float() - b[:, i:i + 256].float()).abs().max())
                  for i in range(0, S, 256))
        check(err <= 0.05 * top, f"{cfg.name}: kernel and plain logits differ by {err:.4f}, "
              f"more than 5% of {top:.3f}")
        lk, lpl = float(fast["loss_fn"]["value"]), float(plain["loss_fn"]["value"])
        rel = abs(lk - lpl) / abs(lpl)
        check(math.isfinite(lk) and rel <= 1e-2, f"{cfg.name}: losses {lk} and {lpl}")
        print(f"  logits kernel vs plain path: max |diff| {err:.4f}, tolerance 5% of the largest "
              f"{top:.3f} = {0.05 * top:.4f}; loss {lk:.6f} vs {lpl:.6f}, relative difference "
              f"{rel:.2e}; flash launches per call {cfg.n_layers} "
              f"({'causal' if not cfg.encoder_only else 'no causal mask'}, hd={hd}, wgmma), "
              f"none on the plain path")
        for label, rec in (("kernel", fast), ("plain", plain)):
            print(f"  {label:6s} path: " + "; ".join(
                f"{w} {r['ms']:.3f} ms (host clock, synchronised), peak memory "
                f"{r['peak_gb']:.2f} GB above the weights" for w, r in rec.items()) + f" [{smi}]")
        out[name] = {"launches": {k: v + fast["loss_fn"]["launches"][k]
                                  for k, v in fast["forward_logits"]["launches"].items()},
                     "logits_max_abs_diff": err, "loss": [lk, lpl], "loss_rel": rel,
                     **{f"{label}_{w}_{k}": r[k] for label, rec in (("kernel", fast),
                                                                   ("plain", plain))
                        for w, r in rec.items() for k in ("ms", "peak_gb")}}
        del params, batch, runs, fast, plain, a, b
        gc.collect()
        torch.cuda.empty_cache()
    return out


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
    with ThreadPoolExecutor(len(build.SOURCES) + 1) as pool:     # one nvcc per source
        m_variant = pool.submit(build_m_variant)                  # and the m A/B's variant
        libs = dict(zip(build.SOURCES, pool.map(lambda n: build.build(n, verbose=True),
                                                build.SOURCES)))
        m_variant_lib = m_variant.result()
    print(f"# build: {time.perf_counter() - t0:.1f} s ({', '.join(sorted(libs))})")
    gauss_instr = gauss_instructions(libs["zo_direction"])
    uniform_instr = uniforms_instructions(libs["zo_direction"])
    print("# the ZO kernels' registers and spills (-Xptxas -v):")
    zo_regs = ptxas_lines("zo_direction")
    redesigned = {name: {k: u for k, u in zo_regs.items() if re.fullmatch(kern, k)}
                  for name, kern in (
                      ("zo_reconstruct_update", r"reconstruct_kernel<\d+, \d+, [12]>"),
                      ("zo_reconstruct_flat", r"reconstruct_kernel<\d+, \d+, 0>"),
                      ("zo_perturb_flat", "perturb_flat_kernel"),
                      ("zo_sumsq", "sumsq_leaf_kernel|sumsq_total_kernel"))}
    for name, usage in redesigned.items():
        check(bool(usage) and all(u.get("spill_stores") == 0 and u.get("spill_loads") == 0
                                  for u in usage.values()), f"{name}'s kernels spill: {usage}")
    exp_instr = probe_instructions(libs["selective_scan"], "ss_probe_exp", "ss_probe_base",
                                   "one expf", 3)
    from repro_torch.kernels import selective_scan as ss

    scan_sass = {L: scan_loop_instructions(libs["selective_scan"], L, 16 // L, exp_instr, 16)
                 for L in ss.LANES}

    from repro_torch.core.engine import FlatEngine
    from repro_torch.models.mlp import init_mlp_classifier

    fig2_params = init_mlp_classifier(torch.Generator().manual_seed(0), 54, 7,
                                      hidden=1300, device=dev)
    check(sum(p.numel() for p in fig2_params.values()) == 1_771_907, "d != 1,771,907")
    fig2_layout = FlatEngine(fig2_params, seed=0)
    check(fig2_layout.n_blocks == 437 and fig2_layout.padded_dim == 1_789_952,
          "the Fig. 2 packed buffer is not 437 blocks, P=1,789,952")

    print("# phase: the Gaussian's parts, timed apart (probes, back to back)")
    probes = gauss_probe_phase(torch, dev, libs["zo_direction"])
    print("# phase: kernels vs plain versions on the card")
    rows = kernel_phase(torch, dev, fig2_params, gauss_instr, m_variant_lib=m_variant_lib)
    rows["zo_reconstruct_update"]["gauss_probes"] = probes
    print("# phase: Fig. 2 main path (engine=flat, SGD) vs engine=fused")
    main_launches = fig2_phase(torch, dev)
    print("# phase: profile of the main path's ZO step")
    profile_phase(torch, dev)
    print("# phase: generic flat path (engine=flat, Adam)")
    generic_launches = generic_flat_phase(torch, dev)
    print("# phase: Fig. 1 universal attack (engine=flat)")
    fig1_phase(torch, dev)
    print("# phase: per-leaf kernels vs plain versions on the card")
    leaf_rows = leaf_kernel_phase(torch, dev, gauss_instr, uniform_instr)
    for name, usage in redesigned.items():
        row = rows[name] if name in rows else leaf_rows[name]
        row["registers"] = {k: u["registers"] for k, u in usage.items()}
    print("# phase: the Fig. 2 method set at hidden=1300 (engine=pallas)")
    method_launches = method_set_phase(torch, dev)
    print("# phase: federated partial participation at hidden=1300 (fed-HO-SGD, FedAvg)")
    fed_launches = federated_phase(torch, dev)
    print("# phase: HO-SGD through make_distributed_ho_sgd: one process, then 4 gloo ranks")
    dist_launches = distributed_phase(torch, dev)
    print("# phase: the LLM trainer (launch.train main): gemma2-2b at full width, engine=flat;"
          " 100m with flat, pallas and tree")
    train = train_phase(torch, dev, gauss_instr)
    print("# phase: the cluster simulator at Fig. 2's width (make_sim_methods + simulate), "
          "engine flat vs tree")
    print("# phase: the trainer on arctic-480b (MoE) and hymba-1.5b (hybrid) at --reduce 100m:"
          " flat, pallas and tree")
    arch_train = {arch: train_100m(torch, dev, flags, aux=arch == "arctic-480b")
                  for arch, flags in TRAIN_ARCHS.items()}
    print("# phase: sharded placements, launch.train main on gloo ranks sharing cuda:0: "
          "gemma2-2b --reduce full --model-axis 2; gemma2-2b and arctic-480b (fsdp) at 100m on "
          "(data=2, model=2)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = sharded_phase(torch, dev, train["a"])
    print(f"  sharded phase: {time.perf_counter() - t0:.1f} s")
    print("# phase: the launch tooling held to this run: launch.dryrun's peaks and gathered "
          "bytes, launch.overlap over a traced sharded FO step, bench.kernels_bench --smoke")
    gc.collect()
    torch.cuda.empty_cache()
    tooling = dryrun_phase(torch, dev, train["a"], sharded["a"])
    print(f"  launch tooling phase: {tooling['wall_s']:.1f} s")
    sim_launches = sim_phase(torch, dev)
    print("# phase: open-loop serving traffic, launch.serve --traffic poisson:50.0,mixed on "
          "qwen3-14b at full width")
    traffic = traffic_phase(torch, dev)
    path_launches = {"federated fed-HO-SGD engine=flat": fed_launches["flat"],
                     "federated fed-HO-SGD engine=pallas": fed_launches["pallas"],
                     "distributed (a) one process, m=4": dist_launches["a"],
                     "distributed (b) 4 gloo ranks, all ranks": dist_launches["b"],
                     TRAIN_FULL: train["a"]["launches"],
                     TRAIN_100M: train["b"]["pallas"]["launches"], **sim_launches,
                     SHARDED_FULL: sharded["a"]["launches"],
                     **{sharded_path(arch): run["launches"]
                        for arch, run in sharded["b"].items()},
                     **{f"train {arch} --reduce 100m, engine={engine}": run[engine]["launches"]
                        for arch, run in arch_train.items() for engine in ("flat", "pallas")}}
    print("# phase: profile of the ZO step with engine=pallas")
    profile_phase(torch, dev, engine="pallas")
    print("# phase: flash attention vs its plain version on the card")
    flash = flash_phase(torch, dev)
    print("# phase: serving qwen3-14b at full width and depth (kernel vs plain path)")
    serve = serve_phase(torch, dev)
    print("# phase: profiles of one 1000-token prefill and one decode step")
    serve_profiles(torch, serve["cfg"], serve["params"], max(serve["prompts"], key=len))
    del serve["params"]                   # qwen3-14b's 29.5 GB go before falcon-mamba's
    gc.collect()
    torch.cuda.empty_cache()

    print("# phase: selective scan, rmsnorm and flash at hd=80 vs their plain versions on the card")
    scan = scan_phase(torch, dev, exp_instr, scan_sass[ss.SERVED_LANES]["tile_steps"])
    norm = rmsnorm_phase(torch, dev)
    hubert = hubert_flash_phase(torch, dev)
    print("# phase: serving falcon-mamba-7b at full width and depth (kernel vs plain path)")
    import numpy as np

    from repro_torch.configs import get_config

    rng = np.random.default_rng(1)
    lens = [64, 1024] + [64 * int(k) for k in rng.integers(1, 17, 6)]
    mamba = serve_phase(torch, dev, cfg=get_config("falcon-mamba-7b"), lens=lens,
                        kernel="selective_scan")
    print("# phase: profiles of one 1024-token prefill on each path and one decode step "
          "(falcon-mamba-7b)")
    prefill_paths = mamba_profiles(torch, mamba["cfg"], mamba["params"],
                                   max(mamba["prompts"], key=len))
    del mamba["params"]                   # falcon-mamba-7b's 14 GB go before qwen3-moe's
    gc.collect()
    torch.cuda.empty_cache()
    print(f"# phase: serving qwen3-moe-235b-a22b at full width, {MOE_LAYERS} layers (kernel vs "
          f"plain path)")
    moe = moe_serve_phase(torch, dev)
    print("# phase: serving hymba-1.5b at full width and depth (scan kernel vs plain path)")
    hymba = hybrid_serve_phase(torch, dev)
    print("# phase: pixtral-12b and hubert-xlarge forward and loss at full width and depth "
          "(flash kernel vs plain path)")
    frontends = frontend_phase(torch, dev)

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
            **{k: row[k] for k in EXTRA_KEYS if k in row},
        })
        if "launches_per_call" in row:
            kernels[-1]["calls"] = launches // row["launches_per_call"]
    for name, row in leaf_rows.items():
        check(method_launches[name] > 0, f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": CUDA_SRC,
            "replaces": LEAF_REPLACES[name], "launches": method_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "path": "fig2 method set, ho_sgd engine=pallas",
            "shape": f"w2 leaf n={row['n']}" + (", m=4" if name == "zo_reconstruct" else ""),
            **{k: row[k] for k in EXTRA_KEYS if k in row},
        })
        if "launches_per_call" in row:
            kernels[-1]["calls"] = method_launches[name] // row["launches_per_call"]
    # the federated and process-group paths' launches, each read just after its run
    for row in kernels:
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in path_launches.items()
                                   if counts.get(row["name"])}
    for arch in TRAIN_ARCHS:
        for name, engine in (("zo_perturb_flat", "flat"), ("zo_reconstruct_flat", "flat"),
                             ("zo_perturb", "pallas"), ("zo_reconstruct", "pallas")):
            path = f"train {arch} --reduce 100m, engine={engine}"
            check(path_launches[path].get(name, 0) > 0, f"{name} was not launched on {path}")
    for name, path in (("zo_perturb_sumsq", "distributed (a) one process, m=4"),
                       ("zo_reconstruct_update", "distributed (a) one process, m=4"),
                       ("zo_perturb_flat", "federated fed-HO-SGD engine=flat"),
                       ("zo_reconstruct_flat", "federated fed-HO-SGD engine=flat"),
                       ("zo_perturb_flat", "distributed (b) 4 gloo ranks, all ranks"),
                       ("zo_reconstruct_flat", "distributed (b) 4 gloo ranks, all ranks"),
                       ("zo_perturb", "federated fed-HO-SGD engine=pallas"),
                       ("zo_reconstruct", "federated fed-HO-SGD engine=pallas"),
                       ("zo_perturb_flat", TRAIN_FULL), ("zo_reconstruct_flat", TRAIN_FULL),
                       ("zo_perturb", TRAIN_100M), ("zo_reconstruct", TRAIN_100M),
                       *((name, path) for name in GENERIC_PAIR
                         for path in (SHARDED_FULL, *map(sharded_path, SHARDED_100M)))):
        check(path_launches[path].get(name, 0) > 0, f"{name} was not launched on {path}")
    for row in kernels:
        if row["name"] in train["shape"]:
            row["gemma2_2b"] = train["shape"][row["name"]]
    head = flash["rows"][-1]                  # the serving shape at S=2048
    check(serve["launches"]["flash_attention"] > 0, "flash_attention was not launched")
    flash_paths = {TRAFFIC_PATH: traffic["launches"], MOE_PATH: moe["launches"],
                   **{FRONTEND_PATHS[name]: run["launches"] for name, run in frontends.items()}}
    for path, counts in flash_paths.items():
        check(counts.get("flash_attention", 0) > 0, f"flash_attention was not launched on {path}")
    f32 = flash["float32"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_REPLACES, "launches": serve["launches"]["flash_attention"],
        "variant": head["variant"],
        "variant_launches": {k: serve["launches"][f"flash_attention_{k}"]
                             for k in ("wgmma", "tf32x3")},
        "max_abs_err": flash["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "path": "serve qwen3-14b prefill",
        "launches_by_path": {path: counts.get("flash_attention", 0)
                             for path, counts in flash_paths.items()},
        "variant_launches_by_path": {path: {
            k: counts.get(f"flash_attention_{k}", 0) for k in ("wgmma", "tf32x3")}
            for path, counts in flash_paths.items()},
        "qwen3_moe_layout": {k: flash["qwen3_moe"][k] for k in (
            "S", "H", "KV", "hd", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "qwen3_moe_serve": {k: v for k, v in moe.items() if "launches" not in k},
        "frontends": frontends,
        "shape": "B=1 S=2048 H=40 KV=8 hd=128 bf16 causal",
        "by_length": [{k: r[k] for k in ("S", "ms", "plain_ms", "library_ms", "bound_ms")}
                      for r in flash["rows"]],
        "float32": {"variant": f32["variant"], "shape": "B=1 S=2048 H=40 KV=8 hd=128 float32 "
                    "causal", "max_abs_err": flash["float32_max_abs_err"],
                    **{k: f32[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                           "bound_by", "tf32_tflops_issued")}},
        "hd80": {"variant": hubert["variant"], "shape": "B=1 S=1024 H=16 KV=16 hd=80 bf16 "
                 "causal off (hubert-xlarge's widths)",
                 "launches": sum(run["launches"]["flash_attention_hd80"] for run in (serve, mamba))
                 + frontends["hubert-xlarge"]["launches"]["flash_attention_hd80"],
                 "launches_by_run": {**{run["cfg"].name: run["launches"]["flash_attention_hd80"]
                                        for run in (serve, mamba)},
                                     FRONTEND_PATHS["hubert-xlarge"]:
                                     frontends["hubert-xlarge"]["launches"]["flash_attention_hd80"]},
                 **{k: hubert[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")},
                 "float32": {k: hubert["float32"][k] for k in (
                     "variant", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by", "tf32_tflops_issued")}},
    })
    check(mamba["launches"]["selective_scan"] > 0, "selective_scan was not launched")
    head = scan["rows"][-1]                   # falcon-mamba-7b's width at S=1024
    kernels.append({
        "name": "selective_scan", "route": "cuda", "source": SCAN_SRC,
        "replaces": SCAN_REPLACES, "launches": mamba["launches"]["selective_scan"],
        "max_abs_err": scan["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": None,
        "path": "serve falcon-mamba-7b prefill",
        "shape": "B=1 S=1024 di=8192 n=16 float32, final state written",
        "lanes": ss.SERVED_LANES, "state_max_abs_err": scan["state_max_abs_err"],
        "by_length": [{k: r[k] for k in ("S", "ms", "plain_ms", "bound_ms", "ms_by_lanes",
                                         "fastest_lanes")} for r in scan["rows"]],
        "sass": scan_sass[ss.SERVED_LANES], "prefill_1024": prefill_paths,
        "launches_by_path": {HYMBA_PATH: hymba["launches"]["selective_scan"]},
        "hymba_serve": {k: hymba[k] for k in ("decode_ms", "cache_rel")},
    })
    check(hymba["launches"]["selective_scan"] > 0, f"selective_scan was not launched on "
          f"{HYMBA_PATH}")
    check(norm["launches"] > 0, "rmsnorm was not launched")
    head = norm["rows"][0]
    kernels.append({
        "name": "rmsnorm", "route": "cuda", "source": RMSNORM_SRC,
        "replaces": RMSNORM_REPLACES, "launches": norm["launches"],
        "max_abs_err": norm["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "path": "kernels.ops.rmsnorm (no model calls it)",
        "shape": head["shape"],
        "by_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms")}
                     for r in norm["rows"]],
    })
    print(f"# total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
