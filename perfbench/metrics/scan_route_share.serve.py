"""The share of the traced window's prefills that took the selective-scan
kernel, in %: ``kernels.ops.launch_counts()['selective_scan']`` over layers
times prefills.  Zero is a reading here (no prompt on the kernel's route)."""


def read(run):
    if run.get("kind") != "serve" or not run.get("prefills"):
        return None
    return 100.0 * run["scan_launches"] / (run["n_layers"] * run["prefills"])
