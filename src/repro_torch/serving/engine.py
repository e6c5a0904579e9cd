"""Serving engine: a thin layer over the continuous-batching scheduler.

Counterpart of ``repro.serving.engine``.  ``Engine.generate`` submits every
prompt, drains the scheduler and returns the full sequences;
``Engine.submit``/``Engine.step`` are the open-loop surface.  ``serve_step``
(one token against a full-length cache) is the scalar-position decode.
Both take ``shards`` (a ``dist.sharding.ShardedParams``) to serve a rank's
shards partitioned over ``model`` (``serving.scheduler``); ``serve_step``
also takes a sequence-sharded one (``ShardedParams(..., seq_sharded=True)``),
whose caches hold a rank's rows of the sequence.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serving.scheduler import (  # noqa: F401  (re-exported surface)
    Request,
    Scheduler,
    ServeConfig,
    StepReport,
    sample_key,
)


class Engine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 key: Optional[int] = None, shards=None):
        self.cfg = cfg
        self.params = params
        self.sc = serve_cfg
        self.scheduler = Scheduler(cfg, params, serve_cfg, key=key, shards=shards)

    # --- open-loop surface --------------------------------------------- #
    def submit(self, prompt: List[int], max_new: int,
               key_id: Optional[int] = None) -> int:
        return self.scheduler.submit(prompt, max_new, key_id=key_id)

    def step(self) -> StepReport:
        return self.scheduler.step()

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def result(self, rid: int) -> List[int]:
        req = self.scheduler.requests[rid]
        return list(req.prompt) + list(req.out)

    # --- offline generation --------------------------------------------- #
    def generate(self, prompts: List[List[int]], max_new: int,
                 key: Optional[int] = None) -> List[List[int]]:
        """Submit every prompt, drain, return prompt+generated per request.

        ``key`` is the sampling seed and ``key_id`` the position in
        ``prompts``, so repeated calls on one engine with the same ``key``
        resample identically.
        """
        self.scheduler.key = key
        rids = [self.scheduler.submit(list(p), max_new, key_id=i)
                for i, p in enumerate(prompts)]
        while self.scheduler.has_work:
            self.scheduler.step()
        return [self.result(rid) for rid in rids]


def serve_step(cfg: ModelConfig, params, token, pos, caches, shards=None):
    """One new token against a full-length KV cache (updated in place); with
    ``shards`` this rank's shards and cache slices, the sequence too when
    ``shards.seq`` cuts it (``long_500k``: ``init_caches(..., shards=)``)."""
    return T.decode_step(cfg, params, token, pos, caches, shards)
