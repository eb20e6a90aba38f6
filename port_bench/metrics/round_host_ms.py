"""Median host ms around each BatchEngine.run_round in the window (to its
end, which reads the round's age and delta back)."""

from harness.stats import median


def read(rec):
    return median(rec.spans.get("round_host_ms", []))
