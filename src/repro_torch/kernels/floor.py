"""Empty kernels, one by each route the port's kernels take (Triton and
CUDA C++ through ``ctypes``): back to back on the stream, their time is
what one more kernel costs the card, the floor under every kernel's time.
``chip_smoke.py`` prints it beside each kernel's bound; no solver calls
them.  Both launch on the current stream and need a CUDA device.
"""

from __future__ import annotations

import ctypes

import torch

_jit = None


def _empty(n):
    pass


def triton_empty(device: torch.device, programs: int = 1) -> None:
    """Launch an empty Triton kernel of ``programs`` programs on ``device``."""
    global _jit
    if _jit is None:
        from .build import import_triton

        _jit = import_triton().jit(_empty)
    with torch.cuda.device(device):
        _jit[(programs,)](programs, num_warps=1)


def cuda_empty(device: torch.device, blocks: int = 1) -> None:
    """Launch the empty CUDA C++ kernel of ``csrc/floor.cu`` on ``device``."""
    from . import build

    lib = build.load("floor")
    lib.floor_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.floor_empty.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = lib.floor_empty(blocks, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
