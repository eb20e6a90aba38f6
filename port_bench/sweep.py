"""Find the highest rate a stream cell sustains: one sweep on the card.

    python3 port_bench/sweep.py --workload <stream cell> --seconds 10 --rates 60 80 ...

Serves the cell's stream at each offered rate in one process and prints,
per rate, the requests offered, those completed by the window's end, the
backlog then, the p95 latency and whether the answers were correct.  A
rate is sustained where completions keep up with arrivals and the backlog
at the window's end stays at the few requests in flight.  Not run by the
benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=2_900_000_000)
    args = ap.parse_args()
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(HERE / ".cache" / "nv")
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import torch

    from harness import cell
    from harness.stats import nearest_rank

    dev = torch.device("cuda", 0)
    for i, rate in enumerate(args.rates):
        out = cell.run_cell(ROOT, args.workload, args.seed + i, args.seconds, False, dev,
                            time.perf_counter(), {"traffic": {"rate_per_s": rate}})
        rec = out.pop("record")
        done = rec.extra["done_by_window_end"]
        print(json.dumps(dict(rate_per_s=rate, offered=rec.extra["offered"],
                              done_by_window_end=done,
                              backlog_at_window_end=rec.extra["offered"] - done,
                              drained_s=rec.span_s,
                              p95_ms=nearest_rank(rec.latencies_s, 0.95) * 1e3,
                              p50_ms=nearest_rank(rec.latencies_s, 0.5) * 1e3,
                              failed=out["failed"], correct=out["correct"],
                              checks={k: v["value"] for k, v in out["checks"].items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
