"""Signals of the jobs completed in the window over the seconds from the
window's start to the end of the last of them (whole jobs only)."""


def read(rec):
    if rec.unit != "signals" or not rec.completed:
        return None
    return rec.completed / rec.span_s
