"""Public wrapper of the flash attention kernels, with their launch counts.

``flash_attention`` is what :func:`repro_torch.models.attention.gqa_forward`
calls for causal self-attention in the prefill.  It routes statically by
(dtype, D), never on failure (:func:`kernel_for`):

* bf16 with D in :data:`SM90_HEAD_DIMS` -> :func:`flash_attention_sm90`,
  the wgmma kernel (TMA; ``csrc/flash_attention_sm90.cu``);
* float32, and bf16 at any other D in :data:`HEAD_DIMS` ->
  :func:`flash_attention_mma`, the ``mma.sync`` kernel
  (``csrc/flash_attention.cu``): float32 as three TF32 products of split
  operands, bf16 with P split into bf16 hi + lo.

Both are CUDA C++, built by :mod:`..build`; each counts its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import on_meta, report_launch, require_cuda_operands
from .ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the mma kernel's float32 instances
SM90_HEAD_DIMS = (64, 128, 256)  # the wgmma kernel's (bf16 only)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, o; B, Sq, Sk, H, KH, D; the mma kernel's dtype code; causal, scale, stream
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
_TAIL = [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _entry(stem: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of the library built from ``csrc/<stem>.cu``."""
    from .. import build

    fn = getattr(build.load(stem), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """``"sm90"`` (the wgmma kernel) or ``"mma"`` (the mma.sync kernel): which
    kernel a CUDA call with operands of ``dtype`` and head size ``d`` launches."""
    return "sm90" if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS else "mma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T * D**-0.5 [masked]) v in the (B, S, H, D) GQA layout.

    q is (B, Sq, H, D), k and v (B, Sk, KH, D) with H % KH == 0; query head h
    reads KV head h // (H // KH).  ``causal`` needs Sq == Sk and raises
    otherwise: the reference's Pallas kernel masks such a case top-left and
    its oracle bottom-right, so it has no one meaning.  CPU tensors take the
    plain version; CUDA tensors launch the kernel :func:`kernel_for` names,
    which takes float32 or bf16, D in :data:`HEAD_DIMS`, any S, contiguous
    16-byte aligned operands of one dtype on one device, and raises
    otherwise; ``meta`` tensors take the shape-propagation route of the
    kernel the card would launch (:mod:`repro_torch.kernels`).
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, Sq, H, D) and k, v (B, Sk, KH, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (need the same B and D, H % KH == 0)")
    if causal and sq != sk:
        raise ValueError(f"causal flash_attention needs Sq == Sk; got Sq={sq}, Sk={sk} (the "
                         "reference's kernel and oracle disagree on where such a mask sits)")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal=causal)
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32 or bf16; got {q.dtype}")
    require_cuda_operands("flash_attention", {"q": q, "k": k, "v": v},
                          dict.fromkeys("qkv", q.dtype))
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}; got D={d}")
    if not (0 < sq and 0 < sk and 0 < b <= 65535 and 0 < h <= 65535):
        raise ValueError(f"flash_attention kernel needs non-empty operands and B, H <= 65535 "
                         f"(its grid); got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel reads 16-byte vectors: operands must be "
                         "16-byte aligned")
    if kernel_for(q.dtype, d) == "sm90":
        return flash_attention_sm90(q, k, v, causal=causal)
    return flash_attention_mma(q, k, v, causal=causal)


def flops(q: torch.Tensor, k: torch.Tensor, causal: bool) -> float:
    """The two products' operations, 4 B H Sq Sk D, halved when causal: the
    count a launch reports to the cost walk (the float32 kernel's three TF32
    products a term are not counted apart)."""
    b, sq, h, d = q.shape
    return 4.0 * b * h * sq * k.shape[1] * d / (2 if causal else 1)


def flash_attention_sm90(q, k, v, *, causal: bool) -> torch.Tensor:
    """Launch the wgmma kernel on operands :func:`flash_attention` has
    checked (bf16, D in :data:`SM90_HEAD_DIMS`)."""
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    if on_meta(q, k, v):
        report_launch("flash_attention_sm90", q, k, v, o, flops=flops(q, k, causal))
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("flash_attention_sm90", "flash_attention_sm90_fwd", _ARGS + _TAIL)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, k.shape[1], h,
            k.shape[2], d, int(causal), d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_sm90 kernel launch failed: cudaError {err}")
    flash_attention_sm90.launches += 1
    report_launch("flash_attention_sm90", q, k, v, o, flops=flops(q, k, causal))
    return o


def flash_attention_mma(q, k, v, *, causal: bool) -> torch.Tensor:
    """Launch the mma.sync kernel on operands :func:`flash_attention` has
    checked (float32 at D in :data:`HEAD_DIMS`; bf16 at D = 8, 16, 32)."""
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    if on_meta(q, k, v):
        report_launch("flash_attention_mma", q, k, v, o, flops=flops(q, k, causal))
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("flash_attention", "flash_attention_fwd", _ARGS + [ctypes.c_int] + _TAIL)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, k.shape[1], h,
            k.shape[2], d, _DTYPE_CODES[q.dtype], int(causal), d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention_mma.launches += 1
    report_launch("flash_attention_mma", q, k, v, o, flops=flops(q, k, causal))
    return o


flash_attention_sm90.launches = 0
flash_attention_mma.launches = 0
