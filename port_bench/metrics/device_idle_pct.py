"""100 x (1 - busy / wall) over a steady slice traced by torch.profiler (CUDA
activity): busy is the union of the device's kernels, copies and memsets."""


def read(rec):
    p = rec.profile
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
