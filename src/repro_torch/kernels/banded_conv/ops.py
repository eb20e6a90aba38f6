"""Public wrapper of the banded circulant (blur) matvec, with its launch count."""

from __future__ import annotations

import ctypes

import torch

from .. import on_meta, report_launch, require_cuda_operands
from .ref import banded_circulant_matvec_ref

TILE = 1024  # outputs per block of the CUDA kernel (csrc/banded_conv.cu)
# the kernel stages TILE + order - 1 floats in shared memory; this keeps
# them inside the 48 KB a block gets without opting in to more
MAX_ORDER = 8192


def _library() -> ctypes.CDLL:
    from .. import build

    lib = build.load("banded_conv")
    lib.banded_conv_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p
    ]
    lib.banded_conv_f32.restype = ctypes.c_int
    return lib


def blur_apply(taps: torch.Tensor, x: torch.Tensor, *, order: int) -> torch.Tensor:
    """y[i] = sum_t taps[t] x[(i + t) mod n] — an order-L first-row circulant
    (the Sec. 7 blur) applied in O(nL); ``x`` is (..., n), any n.

    ``taps`` is (>= order,).  CPU tensors take the plain version; CUDA
    tensors launch the CUDA kernel, which needs contiguous float32 operands
    and ``order <= MAX_ORDER``, and raises otherwise; ``meta`` tensors take
    the shape-propagation route (:mod:`repro_torch.kernels`).
    """
    n = x.shape[-1] if x.ndim else 0
    if taps.ndim != 1 or not 0 < order <= taps.shape[0] or n == 0:
        raise ValueError(f"blur_apply takes taps (>= order,) and x (..., n >= 1); got taps "
                         f"{tuple(taps.shape)}, x {tuple(x.shape)}, order {order}")
    if x.device.type == "cpu" and taps.device.type == "cpu":
        return banded_circulant_matvec_ref(taps, x, order=order)
    require_cuda_operands("banded_conv", {"taps": taps, "x": x},
                          {"taps": torch.float32, "x": torch.float32})
    if order > MAX_ORDER:
        raise ValueError(f"banded_conv kernel takes order <= {MAX_ORDER}; got {order}")
    batch = x.numel() // n
    if not 0 < batch <= 65535:
        raise ValueError(f"banded_conv kernel takes 1..65535 signals; got {batch}")
    y = torch.empty_like(x)
    if not on_meta(taps, x):
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _library().banded_conv_f32(
                taps.data_ptr(), x.data_ptr(), y.data_ptr(), n, batch, order, stream
            )
        if err != 0:
            raise RuntimeError(f"banded_conv kernel launch failed: cudaError {err}")
        blur_apply.launches += 1
    report_launch("banded_conv", taps[:order], x, y, flops=2 * order * x.numel())
    return y


blur_apply.launches = 0
