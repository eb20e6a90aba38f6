"""Public wrapper of the flash attention kernel, with its launch count.

``flash_attention`` is what :func:`repro_torch.models.attention.gqa_forward`
calls for causal self-attention in the prefill.  The kernel is CUDA C++
(``repro_torch/csrc/flash_attention.cu``, built by :mod:`..build`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import require_cuda_operands
from .ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128, 256)  # the kernel's template instances
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    from .. import build

    lib = build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p
    ]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T * D**-0.5 [masked]) v in the (B, S, H, D) GQA layout.

    q is (B, Sq, H, D), k and v (B, Sk, KH, D) with H % KH == 0; query head h
    reads KV head h // (H // KH).  ``causal`` needs Sq == Sk and raises
    otherwise: the reference's Pallas kernel masks such a case top-left and
    its oracle bottom-right, so it has no one meaning.  CPU tensors take the
    plain version; CUDA tensors launch the kernel, which takes float32 or
    bf16, D in :data:`HEAD_DIMS`, any S, contiguous operands of one dtype on
    one device, and raises otherwise.
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
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h, kh, d,
            _DTYPE_CODES[q.dtype], int(causal), d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
