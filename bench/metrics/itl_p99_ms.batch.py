"""The 99th percentile of every gap between consecutive tokens of a
request whose later token reached the host inside the traced run's
window, on the host clock.  It sits inside the stall that an admission's
prefill puts on every resident (about 5% of ticks carry one); its runs
spread too widely for an end-to-end bound (PERF.md, section 2)."""

from benchkit import stats


def read(run):
    w = run.window
    gaps = stats.gaps_in(w.times.values(), w.t0, w.t1)
    if not gaps:
        return None
    return 1e3 * stats.percentile(gaps, 99.0)
