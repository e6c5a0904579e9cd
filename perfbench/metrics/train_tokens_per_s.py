"""Tokens of every step the window completed, first- and zeroth-order alike
(a ZO step consumes its batch in its two evaluations), over the window's
host-clock seconds."""


def read(run):
    if run.get("kind") != "train" or not run["steps"]:
        return None
    return run["tokens"] / run["window_s"]
