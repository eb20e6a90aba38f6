"""Plain PyTorch versions of the wire pack/unpack pair.

Split-complex packing for the transpose all-to-all of
:mod:`repro_torch.dist.fft`: a complex payload is demoted to a real wire
dtype as two stacked planes (re, im) on a new *leading* axis, so the
quantization error enters once per collective and the twiddles, FFT
stages and accumulation stay float32.  ``.to`` rounds to nearest even, as
JAX's cast does, so both packages put the same bits on the wire.

The grouped form is the layout ``all_to_all_single`` sends: ``axis`` of
the payload is cut into ``groups`` chunks, chunk g going to rank g, and
each chunk's two planes lie contiguous as ``out[g]`` — the collective's
split permutation done in the same pass as the cast.
"""

from __future__ import annotations

import math

import torch

# the wire_dtype= plan-knob vocabulary, shared by the plan layer, the
# distributed transforms and the CLI flag
WIRE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def wire_itemsize(wire_dtype: str) -> int:
    """Bytes per real wire element (a complex payload element is 2x this)."""
    return WIRE_DTYPES[wire_dtype].itemsize


def pack_geometry(shape, groups: int, axis: int):
    """(O, I, chunk shape): the payload seen as (O, groups, I), cut along
    ``axis`` into ``groups`` chunks of shape ``chunk shape``."""
    ax = axis % len(shape)
    if shape[ax] % groups:
        raise ValueError(f"axis {axis} of {tuple(shape)} does not split into {groups} chunks")
    chunk = tuple(shape[:ax]) + (shape[ax] // groups,) + tuple(shape[ax + 1:])
    return math.prod(shape[:ax]), math.prod(chunk[ax:]), chunk


def unpack_geometry(chunk, groups: int, axis: int):
    """(O, I, out shape): ``groups`` chunks concatenated along ``axis``,
    the result seen as (O, groups, I)."""
    ax = axis % len(chunk)
    out = tuple(chunk[:ax]) + (chunk[ax] * groups,) + tuple(chunk[ax + 1:])
    return math.prod(chunk[:ax]), math.prod(chunk[ax:]), out


def pack_wire_ref(z: torch.Tensor, wire_dtype: str, groups=None, axis: int = -1):
    """Complex (...) -> (2, ...) planes in ``wire_dtype``; with ``groups=G``,
    (G, 2, *chunk) with ``axis`` cut into G chunks."""
    # copy=True: a contiguous copy even at fp32, where ``.to`` of a strided
    # float32 view would hand back the view itself
    to_wire = dict(dtype=WIRE_DTYPES[wire_dtype], memory_format=torch.contiguous_format,
                   copy=True)
    if groups is None:
        return torch.view_as_real(z).movedim(-1, 0).to(**to_wire)
    o, i, chunk = pack_geometry(z.shape, groups, axis)
    planes = torch.view_as_real(z.reshape(o, groups, i)).permute(1, 3, 0, 2)  # (G, 2, O, I)
    return planes.to(**to_wire).reshape((groups, 2) + chunk)


def unpack_wire_ref(w: torch.Tensor, out_dtype=torch.complex64, grouped: bool = False,
                    axis: int = -1):
    """(2, ...) wire planes -> complex (...), promoted through float32; with
    ``grouped``, (G, 2, *chunk) -> the G chunks concatenated along ``axis``."""
    to_f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format, copy=True)
    if not grouped:
        return torch.view_as_complex(w.movedim(0, -1).to(**to_f32)).to(out_dtype)
    groups, chunk = w.shape[0], tuple(w.shape[2:])
    o, i, out = unpack_geometry(chunk, groups, axis)
    u = w.reshape(groups, 2, o, i).permute(2, 0, 3, 1).to(**to_f32)  # (O, G, I, 2)
    return torch.view_as_complex(u).to(out_dtype).reshape(out)
