"""Prompt tokens prefilled plus tokens generated in the window, finished or
not, over the window's host-clock seconds."""


def read(run):
    if run.get("kind") != "serve":
        return None
    return (run["prompt_tokens"] + run["generated"]) / run["window_s"]
