"""Read the numbers that set a cell's limits, on the card, in one process.

    python3 port_bench/calibrate.py --workload <name> --seeds 12 --control 3 \
        --seconds <s> [--first-seed N]

Runs the cell on ``--seeds`` seeds (the program's readings: the lower end
of each limit) and the control, the plain reference computed with its
arrays in bfloat16 in the program's place, on ``--control`` seeds (the
upper end), at the cell's own sizes and load with a ``--seconds`` window.
Prints one line per run and, last, each number's largest program reading
and smallest control reading.  Not run by the benchmark.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args()
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(HERE / ".cache" / "nv")
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import torch

    from harness import cell

    dev = torch.device("cuda", 0)
    worst, least = {}, {}
    runs = [(False, args.first_seed + i) for i in range(args.seeds)]
    runs += [(True, args.first_seed + 1000 + i) for i in range(args.control)]
    for ctl, seed in runs:
        t0 = time.perf_counter()
        out = cell.run_cell(ROOT, args.workload, seed, args.seconds, False, dev,
                            time.perf_counter(), use_control=ctl)
        rec = out.pop("record")
        nums = {k: v["value"] for k, v in out["checks"].items()}
        side = least if ctl else worst
        for k, v in nums.items():
            side[k] = (min if ctl else max)(side.get(k, v), v)
        print(json.dumps(dict(side="control" if ctl else "program", seed=seed,
                              run_s=round(time.perf_counter() - t0, 3), correct=out["correct"],
                              attempted=out["attempted"], failed=out["failed"], numbers=nums,
                              metrics={k: v["value"] for k, v in out["metrics"].items()},
                              device=out["device"],
                              spans={k: [round(v, 6) for v in vals[:4]]
                                     + ["median", sorted(vals)[len(vals) // 2]]
                                     for k, vals in rec.spans.items() if vals})), flush=True)
    print(json.dumps(dict(program_largest=worst, control_smallest=least,
                          process_s=round(time.perf_counter() - T_START, 1))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
