"""Host-clock ms in ``models.transformer.prefill_at`` per 1,000 prompt tokens,
summed over the traced window's prefills, each call synchronised before and
after."""


def read(run):
    timed = run.get("prefill_timed")
    if not timed or not sum(n for _, n in timed):
        return None
    return 1e6 * sum(s for s, _ in timed) / sum(n for _, n in timed)
