"""``torch.cuda.max_memory_allocated()`` over the whole run, set-up included,
read when the window closes (before the check), in GB (1e9 bytes)."""


def read(run):
    return None if run.get("peak_bytes") is None else run["peak_bytes"] / 1e9
