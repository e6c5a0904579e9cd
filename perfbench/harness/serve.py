"""The serving cell: the port's ``serving.Engine`` on a queued batch job, then checked.

Set-up makes the weights, builds the engine (``Engine(cfg, params,
ServeConfig(...))``, greedy), and serves the mix's warm-up prompts through
it to the end: one whose length is a multiple of 64 (the selective-scan
kernel's route, which builds the kernel) and one that is not (the plain
route), at the longest length the mix sends, so that both routes and the
decode step have run at their largest sizes before the window.  The window
submits every request at once (an offline job whose queue outlasts it) and
calls ``Engine.step`` until ``--seconds`` have passed: each step admits
queued requests into free slots, each paying an exact-length prefill, and
runs one decode step over the slot pool.

The engine's prefill and decode calls are wrapped for the whole window
(``Capture``): each keeps one ``topk`` of its logits on the card, the top
``TOP`` logits (values and token ids) of every row, copied off after the
window: the program's answer for each token it serves.  The
check, once the window has closed and the engine is freed, samples finished
requests from the seed, the longest among them, and runs the plain reference
over each prompt with its served tokens (``logit_gap``).
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from harness import flops, traffic, weights
from harness.profile import Spans, Window, patched

TOP = 8


class Capture:
    """Wraps ``transformer.prefill_at`` and ``transformer.decode_step_slots``
    for the engine's scheduler and keeps, of each call, one ``topk`` of its
    logits on the card: the top ``TOP`` (values, token ids) of every row, the
    program's answer for the token it serves there.  A prefill belongs to the
    next request admitted (the queue is FIFO), a decode row to the slot's
    owner when the step began.  ``rows()``, after the window, copies them off
    the card: for each request, one (values, ids) pair a token served."""

    def __init__(self, T, scheduler, order: List[int]):
        self.sched = scheduler
        self.order = iter(order)
        self.calls: List[tuple] = []        # (owner of each row, values, ids)
        self.orig = T.prefill_at, T.decode_step_slots

    def prefill(self, *a, **kw):
        logits, caches = self.orig[0](*a, **kw)
        self.calls.append(([next(self.order)], *torch.topk(logits[:1], TOP)))
        return logits, caches

    def decode(self, *a, **kw):
        owners = self.sched.pool.owner.tolist()
        logits, caches = self.orig[1](*a, **kw)
        self.calls.append((owners, *torch.topk(logits, TOP)))
        return logits, caches

    def rows(self, rids) -> Dict[int, list]:
        want = set(rids)
        out: Dict[int, list] = {rid: [] for rid in rids}
        for owners, vals, ids in self.calls:
            vals, ids = vals.to(torch.float32).cpu(), ids.cpu()
            for row, rid in enumerate(owners):
                if rid in want:
                    out[rid].append((vals[row], ids[row]))
        return out


def run(ctx, capture: bool = True) -> Dict:
    """One run of the cell; ``capture=False`` (``calibrate.py``'s measure of
    what the capture costs) serves the window without ``Capture`` and
    checks nothing."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, ServeConfig

    model, mix, dev = ctx.cell.config["model"], ctx.cell.traffic, ctx.device
    cfg = ModelConfig(**model)
    if dev.type != "cuda":
        cfg = cfg.with_(use_pallas=False)       # the kernels' plain versions: no route to pick
    params = weights.make(model, ctx.seed, dev)
    eng = Engine(cfg, params, ServeConfig(max_seq=mix["max_seq"], slots=mix["slots"],
                                          temperature=0.0))
    rng = np.random.default_rng(np.random.SeedSequence([int(ctx.seed) % (1 << 64), 3]))
    for n in mix["warmup_prompt_lens"]:
        eng.submit(rng.integers(0, model["vocab_size"], n).tolist(), 2)
    while eng.has_work:
        eng.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reqs = traffic.serve_requests(mix, model["vocab_size"], ctx.seed)
    out: Dict = {"kind": "serve", "n_layers": model["n_layers"],
                 "setup_s": time.perf_counter() - ctx.t_start}

    spans = Spans()
    timed = {"prefill": [], "decode": []}
    traced = ctx.trace and dev.type == "cuda"
    first = eng.scheduler._next_rid
    keep = Capture(T, eng.scheduler, list(range(first, first + len(reqs))))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def clocked(name, fn):
        def call(*a, **kw):
            sync()
            s = time.perf_counter()
            res = fn(*a, **kw)
            sync()
            e = time.perf_counter()
            spans.add(name, s, e)
            timed[name].append((e - s, a[2]["tokens"].shape[1] if name == "prefill" else 0))
            return res
        return call

    prefill, decode = (keep.prefill, keep.decode) if capture else keep.orig
    if ctx.trace:
        prefill, decode = clocked("prefill", prefill), clocked("decode", decode)
    ops.reset_launch_counts()
    prompt_tokens = generated = prefills = 0
    step_flops = 0
    emitted: Dict[int, int] = {}
    finished: List[int] = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(T, "prefill_at", prefill))
        stack.enter_context(patched(T, "decode_step_slots", decode))
        win = stack.enter_context(Window(traced))
        rids = [eng.submit(p, o) for p, o in reqs]
        lens = {rid: len(p) for rid, (p, _) in zip(rids, reqs)}
        while time.perf_counter() - win.t0 < ctx.seconds and eng.has_work:
            s = time.perf_counter()
            rep = eng.step()
            spans.add("scheduler_step", s, time.perf_counter())
            for rid, L, _, _ in rep.admitted:
                prompt_tokens += L
                prefills += 1
                step_flops += flops.prefill(model, L)
            for rid, _ in rep.emitted:
                j = emitted.get(rid, 0)
                emitted[rid] = j + 1
                generated += 1
                if j:                   # a decode token: input token j-1 at position L + j - 1
                    step_flops += flops.decode_token(model, lens[rid] + j - 1)
            finished += [rid for rid, _ in rep.finished]
    out.update(window_s=win.t1 - win.t0, prompt_tokens=prompt_tokens, generated=generated,
               flops=step_flops, prefills=prefills, attempted=prefills,
               scan_launches=ops.launch_counts().get("selective_scan", 0),
               peak_bytes=ctx.peak_bytes())
    if ctx.trace:
        out["trace"] = win.summary(spans)
        out["prefill_timed"] = timed["prefill"]
        out["decode_timed"] = timed["decode"]
    served = {rid: (list(eng.scheduler.requests[rid].prompt),
                    list(eng.scheduler.requests[rid].out)) for rid in finished}
    answers = keep.rows(finished)
    del eng, params, keep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not capture:
        out["numbers"] = {}
        return out
    sample = pick(served, mix["check_requests"], ctx.seed)
    seqs = [served[r] for r in sample]
    out["checked_tokens"] = sum(len(o) for _, o in seqs)
    logits = reference_logits(model, ctx.seed, dev, seqs)
    prog = [answers[r] for r in sample]
    out["numbers"] = {"logit_gap": max(gaps(logits, seqs, prog)) if seqs else float("inf")}
    out["_sample"], out["_ref_logits"], out["_answers"] = seqs, logits, prog
    return out


def pick(served: Dict[int, tuple], k: int, seed: int) -> List[int]:
    """``k`` finished requests drawn from the seed, the longest among them."""
    rids = sorted(served)
    if not rids:
        return []
    longest = max(rids, key=lambda r: (len(served[r][0]) + len(served[r][1]), -r))
    rest = [r for r in rids if r != longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), 4]))
    more = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(more)]


def reference_logits(model: Dict, seed: int, dev, seqs, control: bool = False):
    """The plain reference's logits at every served position of each
    ``(prompt, served)`` pair: a list of ``(len(served), V)`` float32
    tensors, the row for served token j read at position len(prompt)-1+j."""
    from reference.decoder import Decoder

    ref = Decoder(model, control=control)
    w = weights.make(model, seed, dev)
    if not seqs:
        return []
    S = max(len(p) + len(o) - 1 for p, o in seqs)
    toks = torch.zeros((len(seqs), S), dtype=torch.int64, device=dev)
    for i, (p, o) in enumerate(seqs):
        row = (p + o)[:-1]
        toks[i, :len(row)] = torch.as_tensor(row, device=dev)
    with torch.no_grad():
        h = ref.hidden(w, toks)
        out = []
        for i, (p, o) in enumerate(seqs):
            pos = torch.arange(len(p) - 1, len(p) - 1 + len(o), device=dev)
            out.append(ref.logits(w, h[i, pos]))
    return out


def gaps(ref: List[torch.Tensor], seqs, answers) -> List[float]:
    """Per served position, in units of the reference's spread of logits
    there (their standard deviation over the vocabulary): the larger of the
    widest gap between an answer's top logits and the reference's logits of
    the same tokens, and how far the served token's reference logit lies
    below the reference's best.  ``answers[i][j]`` is the (values, token ids)
    of the top logits request i's token j was chosen from."""
    res = []
    for lg, (_, served), rows in zip(ref, seqs, answers):
        for j, (vals, ids) in enumerate(rows):
            r = lg[j].cpu()
            off = float((vals - r[ids]).abs().max())
            short = float(r.max() - r[served[j]])
            res.append(max(off, short) / float(r.std()))
    return res


def top(logits: List[torch.Tensor]) -> list:
    """The top ``TOP`` (values, token ids) of each row, as ``Capture`` keeps them."""
    return [[torch.topk(row.cpu(), TOP) for row in lg] for lg in logits]
