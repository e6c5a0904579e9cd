"""repro_torch.dist — the comm ledger and the wire codecs.

Counterpart of ``repro.dist`` for one card: ``collectives`` holds the
``CommLedger`` (the paper's Table-1 load measured in bytes) and the booking
helpers; ``compress`` the QSGD / signSGD / top-k codecs.  ``sharding`` and the
process-group collectives come with ROADMAP Queue 1 item 9.
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
