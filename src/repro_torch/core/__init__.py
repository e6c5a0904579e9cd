"""HO-SGD (Algorithm 1) in PyTorch; the baselines are not ported yet."""
from repro_torch.core.ho_sgd import (  # noqa: F401
    HOSGDConfig,
    Method,
    adaptive_tau_decision,
    make_adaptive_ho_sgd,
    make_ho_sgd,
    make_sync_sgd,
    make_zo_sgd,
    parse_tau_schedule,
    run_method,
)
