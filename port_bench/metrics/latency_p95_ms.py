"""The 95th percentile (nearest rank) of every request's time from its due
arrival to its result, the stream drained after the window; a request that
did not converge or expired counts as above any limit."""

from harness.stats import nearest_rank


def read(rec):
    if not rec.latencies_s:
        return None
    return nearest_rank(rec.latencies_s, 0.95) * 1e3
