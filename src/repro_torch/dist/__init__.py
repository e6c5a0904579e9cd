"""repro_torch.dist — sharding specs, the comm ledger and the wire codecs.

Counterpart of ``repro.dist``: ``sharding`` holds every spec decision (worker
axes, parameter, batch and cache specs); ``collectives`` the ``CommLedger``
(the paper's Table-1 load measured in bytes), the booking helpers and the
collectives over a ``torch.distributed`` process group; ``compress`` the
QSGD / signSGD / top-k codecs.
"""
from repro_torch.dist.collectives import (  # noqa: F401
    CommLedger,
    all_gather,
    note,
    note_all_reduce,
    pmean,
    psum,
)
from repro_torch.dist.compress import (  # noqa: F401
    Compressor,
    compress_tree,
    get_compressor,
    qsgd,
    signsgd,
    topk,
)
from repro_torch.dist.sharding import (  # noqa: F401
    batch_specs,
    cache_specs,
    n_workers,
    param_specs,
    worker_axes,
)
