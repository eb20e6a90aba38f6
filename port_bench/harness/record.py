"""What one run hands on: its context, its record and its answers."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch


@dataclasses.dataclass
class Context:
    """One run of one cell, as the entry sees it."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    cfg: dict  # the configuration file
    traffic: dict  # the traffic file
    problem: Any  # the harness.problems module of cfg["problem"]
    t_start: float  # time.perf_counter() when the process began its work

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"


@dataclasses.dataclass
class Answers:
    """What the timed path produced, kept for the comparison after the window.

    ``kind`` "fixed": each block is {"y", "x"} after ``iters`` steps.
    ``kind`` "until": each block is {"y", "x", "count", "tol", "min", "max"},
    per-signal tensors of the tolerance driver's contract and its result.
    """

    kind: str
    col: torch.Tensor
    omega: torch.Tensor
    prior: str
    params: dict  # alpha, rho, sigma
    blocks: List[Dict[str, torch.Tensor]]
    iters: Optional[int] = None
    missing: int = 0  # answers due that never came


@dataclasses.dataclass
class Record:
    """What a run measured.  Every field a reader may read is named here;
    a field left None was not measured in this run."""

    unit: str  # what the rate counts: frames, signals or requests
    completed: int  # units completed inside the window
    span_s: float  # window start to the end of the last completion in it
    attempted: int  # answers due in the window
    failed: int  # of those, answers that never came, diverged or missed their contract
    answers: Answers
    setup_s: float = 0.0
    peak_window_bytes: int = 0  # torch.cuda.max_memory_allocated() over the window
    peak_run_bytes: int = 0  # the same over the whole run before the reference
    latencies_s: Optional[List[float]] = None  # per request, inf where it failed
    queue_waits_s: Optional[List[float]] = None
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    step_device_ms: Optional[float] = None
    least_bytes: Optional[float] = None
    profile: Optional[dict] = None  # busy_s, window_s, device_ops, idle_gaps
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
