"""Mean time of one decode step over the window: the benchmark's own
span around the batcher's captured decode step, on the host clock
between two synchronizes of the device."""


def read(run):
    calls = run.timed("decode")
    if not calls:
        return None
    return 1e3 * sum(c[1] for c in calls) / len(calls)
