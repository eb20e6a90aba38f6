"""Median device ms of each replayed round: the engine's own CUDA events
around the graph replay (BatchEngine.timing, replay_events)."""

from harness.stats import median


def read(rec):
    return median(rec.spans.get("round_device_ms", []))
