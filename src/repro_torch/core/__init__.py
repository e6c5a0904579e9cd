"""HO-SGD (Algorithm 1) in PyTorch, its baselines and the round-program IR."""
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
from repro_torch.core.baselines import (  # noqa: F401
    make_gossip_pa_sgd,
    make_pa_sgd,
    make_qsgd,
    make_ri_sgd,
    make_zo_svrg_ave,
)
from repro_torch.core.rounds import (  # noqa: F401
    Round,
    RoundExecutor,
    RoundProgram,
    RoundStep,
    Wire,
    ho_sgd_program,
    masked_average,
    to_method,
)
from repro_torch.core.federated import (  # noqa: F401
    ClientSampling,
    cohort_shards,
    fed_avg_program,
)
