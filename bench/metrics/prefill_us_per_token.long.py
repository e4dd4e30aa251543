"""Admission time per prompt token over the window: the benchmark's own
spans around the batcher's batch-1 prefills (with their scatter and
first token), on the host clock between two synchronizes of the device,
over the prompt tokens they prefilled."""


def read(run):
    calls = run.timed("prefill")
    tokens = sum(c[2] for c in calls)
    if tokens == 0:
        return None
    return 1e6 * sum(c[1] for c in calls) / tokens
