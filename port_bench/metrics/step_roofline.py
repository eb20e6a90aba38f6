"""The least time one CPADMM iteration needs at the cell's shapes (its least
bytes, harness/work.py, at the H100 SXM's 3.35 TB/s) over step_device_ms,
in %.  The card's power limit is printed beside it (device.power)."""

from harness.work import least_ms


def read(rec):
    if not rec.step_device_ms or not rec.least_bytes:
        return None
    return 100.0 * least_ms(rec.least_bytes) / rec.step_device_ms
