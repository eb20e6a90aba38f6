"""Closed-loop jobs and the device bookkeeping every entry shares."""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Tuple

import torch

from . import gen as G
from .record import Context


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    """Return the program's freed blocks before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def closed_loop(ctx: Context, job: Callable[[int], object], n_inputs: int
                ) -> Tuple[int, float, Dict[int, object], list]:
    """Jobs back to back from the window's start until ``ctx.seconds`` have
    passed; job i takes input ``i % n_inputs`` and returns once its result
    is on hand.  -> (jobs completed inside the window, seconds from the
    window's start to the end of the last of them, the outputs kept for the
    comparison, each job's seconds).  Kept: the job at an index drawn from
    the seed among the first ``check_among_first``, and the last completed.
    """
    keep_at = int(G.rng(ctx.seed, "sample").integers(0, ctx.traffic["check_among_first"]))
    kept: Dict[int, object] = {}
    last = None
    done, span, lengths = 0, 0.0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        t_job = time.perf_counter()
        out = job(done % n_inputs)
        t = time.perf_counter()
        if t - t0 > ctx.seconds:
            if last is None:
                kept[done] = out
            break
        lengths.append(t - t_job)
        if done == keep_at:
            kept[done] = out
        last = (done, out)
        done, span = done + 1, t - t0
    if last is not None:
        kept[last[0]] = last[1]
    return done, span, kept, lengths
