from repro_torch.opt.optimizers import (  # noqa: F401
    Optimizer,
    adam,
    apply_deltas,
    const_schedule,
    cosine_schedule,
    invsqrt_schedule,
    sgd,
    theorem_lr,
)
