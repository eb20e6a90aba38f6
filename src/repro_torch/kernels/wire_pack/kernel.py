"""Triton kernels: demote-pack / promote-unpack around a transpose all-to-all.

    pack    complex64 (O, G, I)      -> (G, 2, O, I) planes in the wire dtype
    unpack  (G, 2, O, I) wire planes -> complex64 (O, G, I)

Replace the TPU kernels ``pack_wire_pallas`` and ``unpack_wire_pallas``
(``src/repro/kernels/wire_pack/kernel.py``), which take separate float32
re / im planes split by two XLA passes beforehand, and pad the payload to a
multiple of 1024.

Bound on the H100: bytes.  A cast and a de-interleave, no reuse and no
arithmetic: pack reads 8 B and writes 2 x itemsize B per complex element.
So the design is one streaming pass: complex64 is read (or written) as
(BLOCK, 2) tiles of interleaved float pairs, one 8-byte access a pair, split
into (or joined from) the two planes in registers; a 2-D grid covers
ceil(O*I / BLOCK) tiles of each of the G chunks with the ragged edge masked
(any length, no pad copy), and the G axis (the ranks of the collective) is
the plane layout ``all_to_all_single`` sends, so the split permutation costs
no extra pass.
With G = 1 and O = 1 this is the reference's (2, L) contract.  Demotion
rounds to nearest even, written out, so the wire bits equal torch's and
JAX's casts.

``triton`` is imported on the first launch, never at import time.
"""

from __future__ import annotations

import torch

BLOCK = 1024
NUM_WARPS = 4

tl = None  # triton.language, bound by _compiled() on the first launch
_jits = None


def _pack(z_ptr, out_ptr, OI, I, G, DOWNCAST: tl.constexpr, GROUPED: tl.constexpr,
          BLOCK: tl.constexpr):
    g = tl.program_id(1)
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < OI
    if GROUPED:
        o = offs // I
        src = (o * G + g) * I + (offs - o * I)
    else:
        src = offs
    pairs = (2 * src)[:, None] + tl.arange(0, 2)[None, :]
    re, im = tl.split(tl.load(z_ptr + pairs, mask=mask[:, None], other=0.0))
    if DOWNCAST:
        re = re.to(out_ptr.dtype.element_ty, fp_downcast_rounding="rtne")
        im = im.to(out_ptr.dtype.element_ty, fp_downcast_rounding="rtne")
    dst = g.to(tl.int64) * 2 * OI + offs
    tl.store(out_ptr + dst, re, mask=mask)
    tl.store(out_ptr + dst + OI, im, mask=mask)


def _unpack(w_ptr, out_ptr, OI, I, G, GROUPED: tl.constexpr, BLOCK: tl.constexpr):
    g = tl.program_id(1)
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < OI
    src = g.to(tl.int64) * 2 * OI + offs
    re = tl.load(w_ptr + src, mask=mask, other=0.0).to(tl.float32)
    im = tl.load(w_ptr + src + OI, mask=mask, other=0.0).to(tl.float32)
    if GROUPED:
        o = offs // I
        dst = (o * G + g) * I + (offs - o * I)
    else:
        dst = offs
    pairs = (2 * dst)[:, None] + tl.arange(0, 2)[None, :]
    tl.store(out_ptr + pairs, tl.join(re, im), mask=mask[:, None])


def _compiled():
    global tl, _jits
    if _jits is None:
        from ..build import import_triton

        triton = import_triton()
        tl = triton.language
        _jits = triton.jit(_pack), triton.jit(_unpack)
    return _jits


def pack(z: torch.Tensor, dtype: torch.dtype, o: int, groups: int, i: int) -> torch.Tensor:
    """Launch on a contiguous complex64 CUDA tensor seen as (o, groups, i)
    -> contiguous (groups, 2, o, i) in ``dtype``."""
    out = torch.empty((groups, 2, o, i), dtype=dtype, device=z.device)
    _compiled()[0][(-(-o * i // BLOCK), groups)](
        torch.view_as_real(z), out, o * i, i, groups,
        DOWNCAST=dtype != torch.float32, GROUPED=groups > 1, BLOCK=BLOCK, num_warps=NUM_WARPS,
    )
    return out


def unpack(w: torch.Tensor, o: int, groups: int, i: int) -> torch.Tensor:
    """Launch on contiguous (groups, 2, o, i) wire planes on the card
    -> contiguous complex64 (o, groups, i)."""
    out = torch.empty((o, groups, i), dtype=torch.complex64, device=w.device)
    _compiled()[1][(-(-o * i // BLOCK), groups)](
        w, torch.view_as_real(out), o * i, i, groups,
        GROUPED=groups > 1, BLOCK=BLOCK, num_warps=NUM_WARPS,
    )
    return out
