"""Device ms a ZO step in the engine's plain sum of squares
(``repro_torch.core.engine.DirectionEngine.sumsq``), by CUDA events the
harness records around each call in the traced window."""


def read(run):
    zo = [s for s in run.get("steps", []) if s["order"] == "zo_step"]
    if run.get("sumsq_ms") is None or not zo:
        return None
    return run["sumsq_ms"] / len(zo)
