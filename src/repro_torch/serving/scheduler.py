"""Continuous-batching scheduler over the slotted KV cache.

Counterpart of ``repro.serving.scheduler``: a FIFO admission queue,
prefill-length bucketing (exact lengths for SSM configs, whose post-prompt
state would integrate the pad tokens), admission of new requests into free slots
mid-decode, retirement on EOS or ``max_new``, and one
``decode_step_slots`` over the packed slot pool (per-slot positions, ``-1``
marking free slots) whose shapes never change as requests come and go.

One ``step()`` = (admit as many queued requests as there are free slots,
each paying a bucketed prefill) + (one decode step over the live pool).
``StepReport`` records per-admission bucket lengths and the live-slot count.

Sampling: every (request, token index) draws from its own
``torch.Generator``, seeded with ``fold(seed, key_id, step)`` of the port's
counter hash (``sample_key``).  The draw never depends on the slot or on
which step admitted the request, so sampling at temperature > 0 is the same
under any admission order or pool packing, as in the reference.  It does not
reproduce JAX's draws.

On sharded placements (``shards``, a ``dist.sharding.ShardedParams``) every
rank of the ``model`` axis runs one scheduler on its shards and its slices
of the pool: admission, buckets and eviction are host-side and the same on
every rank, and the logits each prefill and decode step returns are whole
and the same bits on every rank, so every rank samples the same tokens.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.directions import fold
from repro_torch.models import transformer as T
from repro_torch.models.ssm import kernel_path
from repro_torch.serving.cache import SlotKVCache


@dataclass
class ServeConfig:
    max_seq: int
    temperature: float = 0.0
    eos_id: int = -1          # disabled by default (synthetic vocabularies)
    slots: int = 8            # KV-cache pool size == max decode batch
    # prefill bucket lengths (sorted). None = powers of two up to max_seq
    buckets: Optional[Tuple[int, ...]] = None


def default_buckets(max_seq: int) -> Tuple[int, ...]:
    bs: List[int] = []
    b = 8
    while b < max_seq:
        bs.append(b)
        b *= 2
    bs.append(max_seq)
    return tuple(bs)


def sample_key(seed: int, key_id: int, step: int, device="cpu") -> torch.Generator:
    """The generator of one (request, token index): one fold per component."""
    return torch.Generator(device=device).manual_seed(fold(seed, key_id, step))


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    key_id: int               # sampling-key identity (defaults to rid)
    out: List[int] = field(default_factory=list)   # generated tokens
    done: bool = False
    slot: int = -1            # live slot while decoding, -1 otherwise
    submitted: float = 0.0    # time.perf_counter() at submit (the trace's queue wait)


@dataclass
class StepReport:
    """What one scheduler step did."""
    admitted: List[Tuple[int, int, int, int]]  # (rid, prompt_len, bucket_len,
                                               #  slot) — slot AT admission
    live: int                              # slots live for the decode step
    emitted: List[Tuple[int, int]]         # (rid, token) appended this step
    finished: List[Tuple[int, str]]        # (rid, phase) retired this step,
                                           # phase: "prefill" | "decode"


class Scheduler:
    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 key: Optional[int] = None, shards=None):
        assert not cfg.encoder_only, "encoder-only models don't decode"
        assert sc.slots >= 1
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.key = key            # sampling seed (None: greedy)
        self.shards = shards
        self.device = params["embed"].device
        self.pool = SlotKVCache(cfg, sc.slots, sc.max_seq, self.device, shards)
        self.queue: Deque[Request] = deque()
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self._exact = cfg.has_ssm   # pad tokens would corrupt the SSM state
        self._buckets = (None if self._exact else
                         tuple(sorted(sc.buckets or default_buckets(sc.max_seq))))
        self._used_buckets: Set[int] = set()
        self._decode: Callable = (
            lambda p, tok, pos, caches: T.decode_step_slots(cfg, p, tok, pos, caches, shards))
        self._slot_tokens = np.zeros((sc.slots,), np.int64)

    # ------------------------------------------------------------------ #
    def submit(self, prompt: List[int], max_new: int,
               key_id: Optional[int] = None) -> int:
        assert len(prompt) >= 1 and max_new >= 1
        assert len(prompt) + max_new <= self.sc.max_seq, "max_seq too small"
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, list(prompt), max_new,
                      rid if key_id is None else key_id, submitted=time.perf_counter())
        self.requests[rid] = req
        self.queue.append(req)
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.pool.live_slots())

    def prefill_buckets(self) -> Tuple[int, ...]:
        """Bucket lengths (exact prompt lengths for SSM configs) that
        prefills have used so far."""
        return tuple(sorted(self._used_buckets))

    def bucket_for(self, prompt_len: int) -> int:
        if self._exact:
            return prompt_len
        for b in self._buckets:
            if b >= prompt_len:
                return b
        raise AssertionError(f"prompt_len {prompt_len} > max_seq bucket")

    # ------------------------------------------------------------------ #
    def _prefill(self, bucket: int) -> Callable:
        self._used_buckets.add(bucket)
        cfg, shards = self.cfg, self.shards
        return lambda p, toks, last: T.prefill_at(cfg, p, {"tokens": toks}, last, shards)

    def _sample(self, logits: torch.Tensor, key_id: int, step: int) -> int:
        if self.sc.temperature <= 0 or self.key is None:
            return int(torch.argmax(logits))
        # Gumbel-max, as jax.random.categorical draws
        gen = sample_key(self.key, key_id, step, logits.device)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return int(torch.argmax(logits.to(torch.float32) / self.sc.temperature + gumbel))

    def _append(self, req: Request, tok: int, report: StepReport,
                phase: str) -> bool:
        """Record one generated token; returns True when the request retires."""
        req.out.append(tok)
        report.emitted.append((req.rid, tok))
        eos = self.sc.eos_id >= 0 and tok == self.sc.eos_id
        if eos or len(req.out) >= req.max_new:
            req.done = True
            report.finished.append((req.rid, phase))
            if req.slot >= 0:
                self.pool.evict(req.slot)
                req.slot = -1
            return True
        return False

    def step(self) -> StepReport:
        """Admit into free slots, then one decode step over the live pool."""
        with obs.span("serve.step"):
            report = StepReport([], 0, [], [])
            while self.queue and self.pool.free_slots:
                self._admit(self.queue.popleft(), report)
            self._decode_pool(report)
            return report

    def _admit(self, req: Request, report: StepReport) -> None:
        """A bucketed prefill straight into a free slot, and its first token."""
        if obs.tracing():
            obs.interval("serve.queued", req.submitted, f"request/{req.rid}",
                         kind="queue.contention", rid=req.rid)
        L = len(req.prompt)
        bucket = self.bucket_for(L)
        with obs.span("serve.admit", kind="prefill", rid=req.rid, tokens=L) as sp:
            if sp is not None and self.cfg.has_ssm:
                sp.attrs["route"] = "kernel" if kernel_path(self.cfg, bucket) else "plain"
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :L] = req.prompt
            logits, caches = self._prefill(bucket)(
                self.params, torch.as_tensor(toks, device=self.device),
                torch.tensor([L - 1], device=self.device))
            with obs.span("serve.sample"):
                tok = self._sample(logits[0], req.key_id, 0)
            with obs.span("cache.assign"):
                slot = self.pool.alloc(req.rid)
                report.admitted.append((req.rid, L, bucket, slot))
                self.pool.assign(slot, caches, L)
            req.slot = slot
            if not self._append(req, tok, report, "prefill"):
                self._slot_tokens[slot] = tok

    def _decode_pool(self, report: StepReport) -> None:
        """One decode step over the packed live pool."""
        live = self.pool.live_slots()
        report.live = len(live)
        if not live:
            return
        with obs.span("serve.decode", kind="decode"):
            logits, self.pool.caches = self._decode(
                self.params, torch.as_tensor(self._slot_tokens, device=self.device),
                torch.as_tensor(self.pool.pos_vector(), device=self.device),
                self.pool.caches)
            with obs.span("serve.sample"):
                if self.sc.temperature <= 0 or self.key is None:
                    toks = torch.argmax(logits, dim=-1).cpu().numpy()
                else:
                    toks = None
                for slot in live:
                    req = self.requests[int(self.pool.owner[slot])]
                    self.pool.advance(slot)   # the decode wrote req's token at pos
                    tok = (int(toks[slot]) if toks is not None else
                           self._sample(logits[slot], req.key_id, len(req.out)))
                    if not self._append(req, tok, report, "decode"):
                        self._slot_tokens[slot] = tok
