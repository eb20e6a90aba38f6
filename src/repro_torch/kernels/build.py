"""Build the CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Every ``repro_torch/csrc/*.cu`` is compiled for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/repro_torch/`` at
the root of the checkout, where the Triton kernels' compile cache goes too.
A library's file name carries a hash of its source and of the flags, so an
edited source is rebuilt and an unchanged one is reused.  All sources
compile in parallel, one ``nvcc`` each.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def import_triton():
    """``triton``, with its compile cache kept under ``build/`` in the checkout
    (unless ``TRITON_CACHE_DIR`` is already set) rather than in ``$HOME``."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton

    return triton


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's conventional ``/usr/local/cuda/bin/nvcc``; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA toolkit is needed to build repro_torch's CUDA kernels"
    )


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}-{digest[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale ``csrc/*.cu``, in parallel; -> {stem: library}.

    Raises ``RuntimeError`` with nvcc's output if any build fails.  Each
    library's compiler log (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside it as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: library_path(src) for src in sorted(CSRC_DIR.glob("*.cu"))}
    stale = {stem: lib for stem, lib in libs.items() if not lib.exists()}
    if stale:
        nvcc = find_nvcc()
        procs = {}
        for stem, lib in stale.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{stem}.cu")]
            procs[stem] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failures = []
        for stem, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            lib = stale[stem]
            Path(f"{lib}.log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {stem}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, lib)  # atomic publish: a reader never sees half a file
        if failures:
            raise RuntimeError("\n".join(failures))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    if stem not in _loaded:
        libs = build_all()
        if stem not in libs:
            raise RuntimeError(f"no CUDA source csrc/{stem}.cu in {CSRC_DIR}")
        _loaded[stem] = ctypes.CDLL(str(libs[stem]))
    return _loaded[stem]
