"""Run one cell of the port's benchmark once, and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root.  Loads the cell's files (``port_bench/harness/
cell.py``), draws its inputs from the seed, warms up, measures for
``--seconds`` seconds, compares what the timed path produced with the
plain reference (``port_bench/reference/``) and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` (with
``--trace 1`` also ``busy_s``, ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error.

Exits non-zero with no result line when there is no CUDA card, and when a
module of JAX, of the JAX package or of ``benchmarks/`` is loaded once
the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # first: setup_s counts every import after it

import argparse
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"  # fixed, inside the checkout: only a checkout's first run compiles


def _finite(v):
    """JSON has no infinity: a non-finite reading is printed as 1e300."""
    if isinstance(v, float) and not math.isfinite(v):
        return 1e300
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite(x) for x in v]
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import torch

    from harness import cell

    chips = cell.cell_files(ROOT, args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = cell.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START)
    loaded = cell.banned_modules()
    if loaded:
        print(f"modules of JAX, the JAX package or benchmarks/ are loaded: {loaded}",
              file=sys.stderr)
        return 3
    out.pop("record")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
