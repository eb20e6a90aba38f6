"""The port stands alone: no JAX, no reference package, no silent CPU fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.circulant import gaussian_circulant, moving_average_blur
from repro_torch.device import default_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "matvec_sweep.py"] + sorted(
    (ROOT / "examples").glob("torch_*.py"))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    banned = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not banned, f"{path} imports {banned}"


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import sys; import repro_torch, repro_torch.core, repro_torch.core.deblur, "
        "repro_torch.interop, repro_torch.kernels.build, repro_torch.launch.recover, "
        "repro_torch.kernels.soft_threshold.kernel, repro_torch.dist, repro_torch.dist.fft, "
        "repro_torch.dist.recovery, repro_torch.kernels.wire_pack.kernel, "
        "repro_torch.configs.registry, repro_torch.configs.minitron_4b, repro_torch.models.lm, "
        "repro_torch.models.steps, repro_torch.kernels.flash_attention.ops, "
        "repro_torch.ops.operator, repro_torch.core.admm, repro_torch.kernels.floor, "
        "repro_torch.kernels.soft_threshold.ops, repro_torch.ops.prox, repro_torch.core.mapmaking, "
        "repro_torch.core.compression, repro_torch.serve, repro_torch.serve.engine, "
        "repro_torch.launch.serve, repro_torch.dist.compat, repro_torch.launch.train, "
        "repro_torch.models.moe, repro_torch.models.losses, repro_torch.optim.adamw, "
        "repro_torch.models.ssm, repro_torch.models.xlstm, repro_torch.configs.deepseek_v3_671b, "
        "repro_torch.configs.zamba2_1p2b, repro_torch.configs.xlstm_350m, "
        "repro_torch.dist.sharding, repro_torch.dist.blocks, repro_torch.launch.mesh, "
        "repro_torch.launch.partition; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'triton')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        gaussian_circulant(g, 16)  # an entry point given no device
    with pytest.raises(RuntimeError, match="CUDA"):
        moving_average_blur(16, 3)
    assert moving_average_blur(16, 3, device="cpu").col.device.type == "cpu"
