"""Mean host-clock ms of ``models.transformer.decode_step_slots`` over the
traced window's decode steps, each call synchronised before and after."""


def read(run):
    timed = run.get("decode_timed")
    return 1e3 * sum(s for s, _ in timed) / len(timed) if timed else None
