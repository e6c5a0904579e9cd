from repro_torch.data.synthetic import (  # noqa: F401
    DATASET_SPECS,
    Dataset,
    batches,
    make_classification,
    make_digits,
    token_batches,
)
from repro_torch.data.libsvm import parse_libsvm, try_load  # noqa: F401
from repro_torch.data.pipeline import shard_batches, take  # noqa: F401
