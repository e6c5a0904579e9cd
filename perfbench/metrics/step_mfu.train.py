"""The training steps' share of the H100's dense bf16 peak in the traced
run, in %: the model FLOPs of the window's steps over the host-clock seconds
inside them (each step from its call to its loss on the host) times the
peak.  Unlike ``mfu`` it leaves out the time between steps; it bounds what
any kernel's roofline share can claim."""
from harness.peaks import BF16_FLOPS


def read(run):
    steps = run.get("steps") if run.get("kind") == "train" else None
    if not steps:
        return None
    return 100.0 * sum(s["flops"] for s in steps) / (sum(s["s"] for s in steps) * BF16_FLOPS)
