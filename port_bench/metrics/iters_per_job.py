"""Mean over the window's jobs of the steps a solve_until job ran: the
largest count over its signals.  A count."""

import statistics


def read(rec):
    counts = rec.spans.get("iters_per_job")
    return statistics.fmean(counts) if counts else None
