"""Nothing the benchmark runs imports JAX, the JAX package or benchmarks/,
compared by whole top-level module name; the reference imports nothing of
the program or of the harness."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "port_bench"
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in HERE.rglob("*.py") if ".cache" not in p.parts)


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import(path):
    bad = [m for m in imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert tops <= {"torch", "numpy", "math", "__future__"}, tops


def test_a_run_leaves_no_banned_module_loaded():
    code = (
        "import sys, time, torch; from pathlib import Path; "
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(HERE)!r}]; "
        "from harness import cell; "
        "cell.run_cell(Path(" + repr(str(ROOT)) + "), 'sec7-deblur-1024.l1', 7, 0.2, False, "
        "torch.device('cpu'), time.perf_counter(), {'cfg': {'height': 8, 'width': 8, "
        "'frames_per_job': 2, 'iters': 10, 'record_every': 5}}); "
        "bad = cell.banned_modules(); print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
