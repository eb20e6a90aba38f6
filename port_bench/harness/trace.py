"""Device-side measurements of a traced run: step times by CUDA events,
the device's busy share and the breakdown from ``torch.profiler``.

``step_device_ms`` is ``chip_smoke.py:timed``'s method (a device spin
queued first, so the host enqueues every call before the first runs and
the events time the device alone), copied here so that the yardstick does
not change with the program's files.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List, Optional, Tuple

import torch

SPIN_CYCLES = 400_000_000  # ~0.2 s of device spin at H100 clocks: the longest queued
SPIN_MIN_CYCLES = 100_000_000  # ~0.05 s
SPIN_CYCLES_PER_S = 2e9  # the H100's boost clock, ~1.98 GHz
SPIN_MARGIN = 4  # the spin's length over the enqueue the warm-up calls predict


def step_device_ms(fn: Callable[[], None], iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn`` over ``iters`` calls queued behind a spin;
    None when the host's enqueue outlasted the spin (host gaps would enter)."""
    per_call = 0.0
    for i in range(warmup):
        t0 = time.perf_counter()
        fn()
        if i or warmup == 1:
            per_call = max(per_call, time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(min(SPIN_CYCLES, max(SPIN_MIN_CYCLES,
                                      SPIN_MARGIN * iters * per_call * SPIN_CYCLES_PER_S)))
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= 0.9 * spin.elapsed_time(start):
        return None
    return start.elapsed_time(end) / iters


def _device_kind(e) -> bool:
    return "CUDA" in str(e.device_type())


def _is_device_op(e) -> bool:
    """A kernel, copy or memset on the device (not a synchronisation record)."""
    if not _device_kind(e):
        return False
    kind = e.activity_type() if hasattr(e, "activity_type") else "kernel"
    return any(k in kind for k in ("kernel", "memcpy", "memset"))


def profile(fn: Callable[[], None], host: bool) -> list:
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity, and the host's
    with ``host``); -> its kineto events."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return list(prof.profiler.kineto_results.events())


def _intervals(events) -> List[Tuple[int, int]]:
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if _is_device_op(e))
    merged: List[List[int]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(events) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in _intervals(events)) / 1e9


def extent(events) -> Tuple[int, int]:
    """The first start and the last end among ``events``, on their clock."""
    return (min(e.start_ns() for e in events),
            max(e.start_ns() + e.duration_ns() for e in events))


def device_ops(events, top: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took most time."""
    total: dict = {}
    for e in events:
        if _is_device_op(e):
            total[e.name()] = total.get(e.name(), 0) + e.duration_ns()
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in ranked]


def idle_gaps(events, t0: int, t1: int, top: int = 10) -> list:
    """[[host op, seconds], ...]: the device's idle time in [t0, t1], each
    gap put to the innermost host operation running at its midpoint
    ("idle" where none was), summed by name, longest first."""
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
            if not _device_kind(e) and e.duration_ns() > 0]
    total: dict = {}
    edge = t0
    for a, b in _intervals(events) + [(t1, t1)]:
        if a > edge:
            mid = (edge + a) // 2
            inside = [h for h in host if h[0] <= mid <= h[1]]
            name = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "idle"
            total[name] = total.get(name, 0) + (a - edge)
        edge = max(edge, b)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in ranked]


def device_profile(slice_fn: Callable[[], None],
                   host_slice_fn: Callable[[], None]) -> Optional[dict]:
    """One execution of ``slice_fn`` traced for its CUDA activity alone (no
    host activity, whose per-launch cost would read as device idle time):
    the seconds in which some operation ran on the device, over the trace's
    own extent, from the first device operation's start to the last one's
    end, and the slice's device operations.  Beside them, for the
    breakdown only, the idle gaps of ``host_slice_fn`` traced with the
    host's activity too."""
    events = profile(slice_fn, host=False)
    spans = _intervals(events)
    if not spans:
        return None
    out = dict(busy_s=busy_seconds(events), window_s=(spans[-1][1] - spans[0][0]) / 1e9,
               device_ops=device_ops(events))
    events = profile(host_slice_fn, host=True)
    out["idle_gaps"] = idle_gaps(events, *extent(events)) if events else []
    return out


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"
