"""repro_torch.serving — continuous-batching inference over a slotted KV cache.

Counterpart of ``repro.serving``:

  * ``cache``     — ``SlotKVCache``: fixed pool of max_seq-length slots
                    (alloc/assign/evict/gather; decode = the whole pool).
  * ``scheduler`` — FIFO admission, prefill-length buckets, mid-decode
                    admission, EOS/max_new retirement, per-(request, step)
                    sampling generators.
  * ``engine``    — ``Engine``: offline ``generate`` plus the open-loop
                    ``submit``/``step`` surface.
"""
from repro_torch.serving.cache import SlotKVCache  # noqa: F401
from repro_torch.serving.engine import Engine, ServeConfig, serve_step  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    Request,
    Scheduler,
    StepReport,
    default_buckets,
    sample_key,
)
