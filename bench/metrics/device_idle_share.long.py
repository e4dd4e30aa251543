"""Percent of the traced sub-window in which no operation ran on the
device (the union of the profiler's device events inside it)."""


def read(run):
    return run.idle_share()
