"""Recovery-as-a-service: a continuous-batching dispatcher for compressed
signals, in the LLM-serving style: requests bucketed by operator/plan,
packed into batched ``solve_until`` drivers, converged slots recycled to
queued requests mid-run.  Port of ``repro/serve``; on the card each local
bucket's round is one captured CUDA graph
(:class:`~repro_torch.serve.engine.BatchEngine`)."""

from .arrivals import poisson_times, synthetic_workload
from .baseline import static_batch_serve
from .engine import BatchEngine
from .request import (
    Clock,
    ManualClock,
    RecoveryRequest,
    RecoveryResult,
    WallClock,
)
from .server import RecoveryServer, operator_fingerprint, summarize

__all__ = [
    "BatchEngine",
    "Clock",
    "ManualClock",
    "RecoveryRequest",
    "RecoveryResult",
    "RecoveryServer",
    "WallClock",
    "operator_fingerprint",
    "poisson_times",
    "static_batch_serve",
    "summarize",
    "synthetic_workload",
]
