"""The 95th percentile (nearest rank) of admitted_time - arrival_time over
every request of the window."""

from harness.stats import nearest_rank


def read(rec):
    if not rec.queue_waits_s:
        return None
    return nearest_rank(rec.queue_waits_s, 0.95) * 1e3
