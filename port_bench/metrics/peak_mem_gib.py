"""torch.cuda.max_memory_allocated() over the window (reset at its start)."""


def read(rec):
    if not rec.peak_window_bytes:
        return None
    return rec.peak_window_bytes / 2**30
