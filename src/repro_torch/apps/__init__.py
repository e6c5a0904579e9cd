from repro_torch.apps.attack import (  # noqa: F401
    attack_metrics, make_attack_loss, train_victim,
)
from repro_torch.apps.classification import load_dataset, run_comparison  # noqa: F401
