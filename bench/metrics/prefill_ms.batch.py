"""Mean time of one admission over the window: the benchmark's own span
around the batcher's batch-1 prefill, its scatter into a slot and its
first token read back, on the host clock between two synchronizes of
the device."""


def read(run):
    calls = run.timed("prefill")
    if not calls:
        return None
    return 1e3 * sum(c[1] for c in calls) / len(calls)
