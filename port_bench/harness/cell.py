"""One run of one cell: find its files by name, run its entry, compare its
answers, read its metrics and print the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the names in ``BENCHMARK.json``:

    configs/...json           the configuration, as the cell's ``file``
    traffic/<traffic>.json    the traffic mix: its ``entry`` and parameters
    limits/<workload>.json    the limit of each number compared
    metrics/<metric>.py       ``read(record)`` -> the metric, or None; a metric
                              named ``<base>.<cells>`` (``step_device_ms.batch``)
                              is read by ``metrics/<base>.py`` unless a file of
                              its whole name is there
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

import torch

from . import check, jobs, trace
from .record import Context

HERE = Path(__file__).resolve().parents[1]  # port_bench/
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")  # whole top-level names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, workload: str) -> dict:
    """The benchmark's entry for ``workload`` and its files' contents."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    wl = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return dict(bench=bench, workload=wl, cfg=load_json(root / configs[wl["config"]]["file"]),
                traffic=load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{workload}.json"))


def metric_names(bench: dict, workload: str, traced: bool) -> list:
    """The cell's end-to-end metrics (untraced) or per-layer metrics (traced)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader_path(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else the file of
    the name with its last dotted suffixes taken off, one at a time."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:i]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def read_metric(name: str, rec) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(f"metric_{name}", reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, overrides: Optional[dict] = None,
             use_control: bool = False) -> dict:
    """One run -> the result line's object, with the run's ``Record`` under
    ``"record"`` for the tools.  ``overrides`` {"cfg": {...}, "traffic": {...}} replaces
    keys of the files (the CPU tests' tiny sizes, the rate sweep);
    ``use_control`` judges the bfloat16 reference in the program's place."""
    files = cell_files(root, workload)
    cfg, traffic = dict(files["cfg"]), dict(files["traffic"])
    cfg.update((overrides or {}).get("cfg", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    ctx = Context(workload=workload, seed=seed, seconds=seconds, trace=traced, device=device,
                  cfg=cfg, traffic=traffic,
                  problem=importlib.import_module(f"harness.problems.{cfg['problem']}"),
                  t_start=t_start)
    entry = importlib.import_module(f"harness.entries.{traffic['entry']}")
    rec = entry.run(ctx)
    jobs.release(device)

    answers = check.control(rec.answers) if use_control else rec.answers
    numbers = check.compare(answers)
    limits = files["limits"]
    correct = check.judge(numbers, limits)
    del rec.answers, answers
    jobs.release(device)

    metrics = {}
    for m in metric_names(files["bench"], workload, traced):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=1, memory_peak_bytes=rec.peak_run_bytes)
    out = dict(correct=correct, attempted=rec.attempted, failed=rec.failed, metrics=metrics,
               device=dev)
    if traced and rec.profile is not None:
        dev["busy_s"], dev["window_s"] = rec.profile["busy_s"], rec.profile["window_s"]
        dev["power"] = trace.power_limit() if device.type == "cuda" else "not read"
        out["breakdown"] = {"device_ops": rec.profile["device_ops"],
                            "idle_gaps": rec.profile["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in numbers.items()}
    out["record"] = rec
    return out
