"""Public wrappers of the wire pack/unpack kernels, with launch counts.

``pack_wire`` / ``unpack_wire`` are what :mod:`repro_torch.dist.fft` calls
around every transpose all-to-all whose ``wire_dtype`` is not 'fp32'.
"""

from __future__ import annotations

import torch

from .. import on_meta, report_launch, require_cuda_operands
from .ref import (
    WIRE_DTYPES,
    pack_geometry,
    pack_wire_ref,
    unpack_geometry,
    unpack_wire_ref,
    wire_itemsize,  # noqa: F401  (re-exported: the knob's byte size)
)


def pack_wire(z: torch.Tensor, wire_dtype: str, groups=None, axis: int = -1) -> torch.Tensor:
    """Complex payload (...) -> (2, ...) split-complex planes in ``wire_dtype``
    (a :data:`WIRE_DTYPES` key; 'fp32' still packs but demotes nothing).

    ``groups=G`` cuts ``axis`` into G chunks and returns (G, 2, *chunk), the
    layout ``all_to_all_single`` sends.  CPU tensors take the plain version;
    CUDA tensors launch the Triton kernel, which needs a contiguous
    complex64 payload and raises otherwise; ``meta`` tensors take the
    shape-propagation route (:mod:`repro_torch.kernels`).
    """
    dt = WIRE_DTYPES[wire_dtype]
    if z.device.type == "cpu":
        return pack_wire_ref(z, wire_dtype, groups, axis)
    require_cuda_operands("pack_wire", {"z": z}, {"z": torch.complex64})
    if groups is None:
        g, (o, i), shape = 1, (1, z.numel()), (2,) + tuple(z.shape)
    else:
        o, i, chunk = pack_geometry(z.shape, groups, axis)
        g, shape = groups, (groups, 2) + chunk
    if on_meta(z):
        out = torch.empty((g, 2, o, i), dtype=dt, device="meta")
    else:
        from .kernel import pack

        with torch.cuda.device(z.device):
            out = pack(z, dt, o, g, i)
        pack_wire.launches += 1
    report_launch("pack_wire", z, out)
    return out.reshape(shape)


pack_wire.launches = 0


def unpack_wire(w: torch.Tensor, out_dtype=torch.complex64, grouped: bool = False,
                axis: int = -1) -> torch.Tensor:
    """(2, ...) wire planes -> complex payload (...), promoted through float32.

    ``grouped``: ``w`` is (G, 2, *chunk), as received from the ranks of an
    ``all_to_all_single``, and the G chunks are concatenated along ``axis``
    of the chunk.  CPU tensors take the plain version; CUDA tensors launch
    the Triton kernel (complex64 out), which needs contiguous planes in a
    wire dtype and raises otherwise; ``meta`` tensors take the
    shape-propagation route (:mod:`repro_torch.kernels`).
    """
    if w.ndim < (3 if grouped else 1) or w.shape[1 if grouped else 0] != 2:
        raise ValueError(f"unpack_wire takes {'(G, 2, ...)' if grouped else '(2, ...)'} "
                         f"planes; got shape {tuple(w.shape)}")
    if w.device.type == "cpu":
        return unpack_wire_ref(w, out_dtype, grouped, axis)
    if out_dtype != torch.complex64:
        raise ValueError(f"unpack_wire kernel writes complex64, not {out_dtype}")
    if w.dtype not in WIRE_DTYPES.values():
        raise ValueError(f"unpack_wire kernel takes planes in a wire dtype "
                         f"({sorted(WIRE_DTYPES)}); got {w.dtype}")
    require_cuda_operands("unpack_wire", {"w": w}, {"w": w.dtype})
    if grouped:
        g = w.shape[0]
        o, i, shape = unpack_geometry(tuple(w.shape[2:]), g, axis)
    else:
        g, (o, i), shape = 1, (1, w[0].numel()), tuple(w.shape[1:])
    if on_meta(w):
        out = torch.empty((o, g, i), dtype=torch.complex64, device="meta")
    else:
        from .kernel import unpack

        with torch.cuda.device(w.device):
            out = unpack(w, o, g, i)
        unpack_wire.launches += 1
    report_launch("unpack_wire", w, out)
    return out.reshape(shape)


unpack_wire.launches = 0
