"""BENCHMARK.json and the files its names lead to."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "port_bench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files(cell):
    configs = {c["name"]: c for c in BENCH["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    assert (HERE / "harness" / "problems" / f"{cfg['problem']}.py").is_file()
    assert (HERE / "harness" / "entries" / f"{traffic['entry']}.py").is_file()
    assert limits["missing"] == 0 and limits["x_rel_err"] > 0
    assert cell["chips"] == 1
    reported = [m for m in METRICS if cell["name"] in m.get("workloads", [cell["name"]])]
    e2e = {m["name"] for m in reported if m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(m in BENCH["per_layer"] for m in reported)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_its_reader(metric):
    from harness.cell import reader_path

    assert reader_path(metric["name"]).is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")


def test_a_cell_suffix_shares_the_metric_reader():
    from harness.cell import reader_path

    assert reader_path("step_device_ms.batch") == reader_path("step_device_ms.some-new-cell")
    assert reader_path("step_device_ms.batch").name == "step_device_ms.py"
    with pytest.raises(FileNotFoundError):
        reader_path("no_such_metric.batch")


def test_config_files_list_what_they_assume_and_reduce():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["assumed"]
