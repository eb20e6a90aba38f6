"""The benchmark's command on the card: one short run of a cell through
``run.py``, its result line as the contract has it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_run_prints_a_correct_result_line(card, trace):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "sec7-deblur-1024.l1", "--seed", str(2**31 + 3), "--seconds", "3",
                          "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks" and line["metrics"]
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]
