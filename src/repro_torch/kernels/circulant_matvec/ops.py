"""Public wrappers for the direct circulant matvec and its dispatch.

Dispatch policy: the direct kernel when ``n < FFT_CROSSOVER`` and
``n % 128 == 0``, the FFT path otherwise, as the reference
(``repro/kernels/circulant_matvec/ops.py``) dispatches; the crossover itself
is the port's own, chosen from the H100's times (see ``FFT_CROSSOVER``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import on_meta, report_launch, require_cuda_operands
from .ref import circulant_matvec_fft, circulant_matvec_ref

FFT_CROSSOVER = 1 << 13
"""The smallest n at which the FFT path beats the direct kernel at B = 8
signals (Paths B and C), from chip_smoke.py's sweep on an H100 80GB HBM3 at
700 W: for C x at n = 4096 the direct kernel took 0.0134 ms against the FFT
path's 0.0192, at n = 8192 0.0243 against 0.0224, at n = 16384 0.0858
against 0.0312 (at B = 1 the FFT path also first wins at 8192; PERF.md).
C^T x ties at n = 8192 (0.0245 direct, 0.0247 FFT) and CPISTA runs both
products a step, so 2^13 rather than 2^14 rests on ~8% for C x against ~1%
for C^T x at that one size.  The reference's 2^15 was chosen for the TPU."""
BLOCK = 128  # the kernel's n granularity (csrc/circulant_matvec.cu)


def _library() -> ctypes.CDLL:
    from .. import build

    lib = build.load("circulant_matvec")
    lib.circulant_matvec_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p
    ]
    lib.circulant_matvec_f32.restype = ctypes.c_int
    return lib


def circulant_matvec_direct(col: torch.Tensor, x: torch.Tensor, *, transpose: bool = False):
    """y = C @ x (or C^T @ x), C[i, j] = col[(i - j) mod n], in the time domain.

    ``col`` is (n,), ``x`` is (..., n).  CPU tensors take the plain dense
    version; CUDA tensors launch the CUDA kernel, which needs fp32,
    contiguous, 16-byte aligned inputs and ``n % 128 == 0``, and raises
    otherwise; ``meta`` tensors take the shape-propagation route
    (:mod:`repro_torch.kernels`).
    """
    n = col.shape[-1]
    if col.ndim != 1 or x.shape[-1] != n:
        raise ValueError(f"col must be (n,) and x (..., n); got {tuple(col.shape)}, "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu" and col.device.type == "cpu":
        return circulant_matvec_ref(col, x, transpose=transpose)
    require_cuda_operands("circulant_matvec", {"col": col, "x": x},
                          {"col": torch.float32, "x": torch.float32})
    if n % BLOCK:
        raise ValueError(f"circulant_matvec kernel needs n % {BLOCK} == 0; got n={n}")
    if x.data_ptr() % 16:
        raise ValueError("circulant_matvec kernel reads 16-byte vectors: x must be 16-byte "
                         "aligned")
    batch = x.numel() // n
    if not 0 < batch <= 65535:
        raise ValueError(f"circulant_matvec kernel takes 1..65535 signals; got {batch}")
    y = torch.empty_like(x)
    if not on_meta(col, x):
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _library().circulant_matvec_f32(
                col.data_ptr(), x.data_ptr(), y.data_ptr(), n, batch, int(transpose), stream
            )
        if err != 0:
            raise RuntimeError(f"circulant_matvec kernel launch failed: cudaError {err}")
        circulant_matvec_direct.launches += 1
    # three bf16 products a term on the tensor cores (the design chip_smoke.py bounds)
    report_launch("circulant_matvec", col, x, y, flops=3 * 2 * batch * n * n)
    return y


circulant_matvec_direct.launches = 0


def circulant_matvec(col: torch.Tensor, x: torch.Tensor, *, transpose: bool = False):
    """y = C @ x (or C^T @ x): the direct kernel below :data:`FFT_CROSSOVER`
    (n % 128 == 0), the FFT path otherwise."""
    n = col.shape[-1]
    if n < FFT_CROSSOVER and n % BLOCK == 0:
        return circulant_matvec_direct(col, x, transpose=transpose)
    return circulant_matvec_fft(col, x, transpose=transpose)
