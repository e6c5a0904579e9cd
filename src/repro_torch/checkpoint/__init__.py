from repro_torch.checkpoint.checkpoint import latest_step, restore, save  # noqa: F401
