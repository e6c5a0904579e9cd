"""Slotted KV cache: a fixed pool of ``max_seq``-length cache slots.

Counterpart of ``repro.serving.cache``.  The pool is one cache tree
(``T.init_caches`` over ``slots`` batch rows) on the model's device; a
request owns exactly one slot from admission to retirement.
``alloc``/``evict`` manage the host-side free list, ``assign`` copies a
single-request prefill cache into its slot, and the decode batch is the
whole pool driven with a per-slot position vector (``-1`` for free slots),
so admission and eviction never change the decode's shapes.  ``gather``
pulls per-slot copies back out for inspection and tests.  An SSM's pool holds
per-slot conv and ssm states instead of (or beside) k and v.  The pool is on
the card unless the caller asks for ``device="cpu"``.  On sharded placements
(``shards``, a ``dist.sharding.ShardedParams``) the pool is this rank's
slice of every cache leaf (``T.init_caches(..., shards=)``); the slot
bookkeeping is host-side and the same on every rank.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def _scatter_slot(pool: Dict, prefill: Dict, slot: int) -> Dict:
    """Write a B=1 prefill cache tree into pool row ``slot``, IN PLACE (the
    reference donates the pool and returns a new one; here the pool's own
    storage is written).  Leaves are layer-stacked ``(L, B, ...)`` with the
    slot axis 1, and the prefill's leaf fills the leading rows of axis 2, as
    the reference's ``dynamic_update_slice`` at ``(0, slot, 0, ...)`` does:
    k and v positions ``[0, bucket)``, the whole ``(d_inner, n)`` ssm state,
    and the first ``min(prompt_len, K - 1)`` rows of the conv state."""
    for name, p in pool.items():
        c = prefill[name]
        p[:, slot, :c.shape[2]].copy_(c[:, 0])
    return pool


class SlotKVCache:
    """Fixed pool of ``slots`` KV-cache rows, each ``max_seq`` long."""

    def __init__(self, cfg: ModelConfig, slots: int, max_seq: int, device="cuda",
                 shards=None):
        assert slots >= 1 and max_seq >= 1
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.caches: Dict = T.init_caches(cfg, slots, max_seq,
                                          getattr(torch, cfg.dtype), device, shards)
        self._free: List[int] = list(range(slots - 1, -1, -1))  # pop() -> 0 first
        # host-side per-slot metadata: next write position (-1 = free slot)
        self.pos = np.full((slots,), -1, np.int64)
        self.owner = np.full((slots,), -1, np.int64)   # request id, -1 = free

    # ------------------------------------------------------------------ #
    @property
    def free_slots(self) -> int:
        return len(self._free)

    def live_slots(self) -> List[int]:
        return [s for s in range(self.slots) if self.owner[s] >= 0]

    def alloc(self, rid: int) -> Optional[int]:
        """Claim a free slot for request ``rid`` (None when the pool is full)."""
        if not self._free:
            return None
        slot = self._free.pop()
        assert self.owner[slot] < 0, f"slot {slot} double-allocated"
        self.owner[slot] = rid
        return slot

    def assign(self, slot: int, prefill_caches: Dict, prompt_len: int) -> None:
        """Install a request's prefill cache (B=1 tree, any bucket length
        <= max_seq) into ``slot``; decode continues at ``prompt_len``."""
        assert self.owner[slot] >= 0, f"assign to unallocated slot {slot}"
        assert 0 < prompt_len <= self.max_seq
        self.caches = _scatter_slot(self.caches, prefill_caches, slot)
        self.pos[slot] = prompt_len

    def advance(self, slot: int) -> None:
        """One decode token written at ``pos[slot]``; bump the position."""
        assert self.owner[slot] >= 0
        self.pos[slot] += 1
        assert self.pos[slot] <= self.max_seq, "slot overran max_seq"

    def evict(self, slot: int) -> None:
        """Retire the slot's request and return the slot to the free pool.

        The cache rows are NOT zeroed: the next ``assign`` overwrites the
        prompt region and decode overwrites (then reads) strictly position
        by position, so stale rows are never attended.
        """
        assert self.owner[slot] >= 0, f"evict of free slot {slot}"
        self.owner[slot] = -1
        self.pos[slot] = -1
        self._free.append(slot)

    def gather(self, slots) -> Dict:
        """Per-slot cache copies (packed along axis 1) for the given slots."""
        some = next(iter(self.caches.values()))
        idx = torch.as_tensor(list(slots), dtype=torch.int64, device=some.device)
        return {k: c.index_select(1, idx) for k, c in self.caches.items()}

    def pos_vector(self) -> np.ndarray:
        """(slots,) int32 positions for ``decode_step_slots``; -1 = inactive."""
        return self.pos.astype(np.int32)

    def check_invariants(self) -> None:
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for s in range(self.slots):
            if s in free:
                assert self.owner[s] < 0 and self.pos[s] < 0
            else:
                assert self.owner[s] >= 0, f"slot {s} neither free nor owned"
                assert 0 < self.pos[s] <= self.max_seq
