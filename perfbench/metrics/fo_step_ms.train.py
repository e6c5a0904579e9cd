"""Mean host-clock ms of the window's first-order steps, each from its call to
its loss on the host."""


def read(run):
    ms = [1e3 * s["s"] for s in run.get("steps", []) if s["order"] == "fo_step"]
    return sum(ms) / len(ms) if ms else None
