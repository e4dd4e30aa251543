"""Percent of the decode rows that carried a live request, per tick, over
the window: the live requests each tick stepped (``tick``'s return) over
the batcher's slots."""


def read(run):
    ticks = run.in_window()
    if not ticks:
        return None
    return 100.0 * sum(t.rows for t in ticks) / (len(ticks) * run.num_slots)
