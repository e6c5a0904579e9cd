"""The share of the traced window in which no operation ran on the device, in
%, from the profiler's device timeline."""


def read(run):
    tr = run.get("trace")
    if run.get("kind") != "train" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
