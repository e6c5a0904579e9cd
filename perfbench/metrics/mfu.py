"""Model FLOPs of the window's work (``harness.flops``) over the window's
host-clock seconds times the H100's dense bf16 peak (``harness.peaks``), in %."""
from harness.peaks import BF16_FLOPS


def read(run):
    if not run.get("flops"):
        return None
    return 100.0 * run["flops"] / (run["window_s"] * BF16_FLOPS)
