"""Distributed four-step FFT over ``torch.distributed``: one transpose per transform.

Port of the flat path of ``repro/dist/fft.py``.  The length-``n`` DFT is
decomposed over ``n = n1 x n2`` (Bailey's four-step algorithm), laid out
as an ``(n1, n2)`` matrix ``A[j1, j2] = x[j1 + n1*j2]`` whose rows are
split over the mesh's model axis of ``p`` ranks.  One forward transform is

    1. local FFT of length n2 along the rows,
    2. local twiddle multiply  W_n^{j1*k2},
    3. one all-to-all transpose (rows -> columns), and
    4. local FFT of length n1 along the columns,

giving the spectrum ``F[k1, k2] = X[n2*k1 + k2]`` split by columns:

    signal domain     (..., n1/p, n2)  real      this rank's rows
    frequency domain  (..., n1, n2/p)  complex   this rank's columns

so a circulant matvec (paper Sec. 4, ``C x = F^H diag(spec) F x``) costs
two transposes and a local pointwise multiply.  Every function here takes
and returns this rank's *blocks*: where the reference's ``shard_map``
scatters a global array, each rank of the port holds only its own.

``rfft``: the half-spectrum pair (:func:`rfft2_local` /
:func:`irfft2_local`) keeps the ``nf = n2//2 + 1`` columns that determine a
real signal's spectrum, zero-padded to a multiple of ``p``: half the FFT
flops and half the wire bytes.

``overlap=K`` cuts the axis each transpose does *not* split (rows forward,
columns inverse) into K chunks; chunk i's all-to-all is issued
(``async_op=True``) before chunk i+1's first stage runs, and the chunks are
reassembled locally (:func:`_gather_fwd_chunks`).  Same numbers as K = 1.

``wire_dtype='bf16'|'fp16'`` demotes every transpose payload through the
``wire_pack`` kernels: the payload is packed into split-complex planes in
the layout ``all_to_all_single`` sends, exchanged in its own dtype (gloo
carries bf16 and fp16 but not 16-bit integers, so the reference's uint16
bitcast has no counterpart) and promoted on arrival.  Twiddles, FFT stages
and accumulation stay float32, so quantization enters once per collective.
``'fp32'`` sends the complex payload as float32 pairs, bit-exact.

Hierarchical two-stage exchange (``axis_name=(host, device)``,
``hier=True``): the transform axis factors as p = H x D over a hierarchical
mesh (:func:`repro_torch.dist.compat.make_hier_mesh`), device-major (rank
(h, d) holds block d*H + h).  A flat all-to-all over the pair
(``hier=False``) pushes the whole payload across the host boundary; the
two-stage exchange runs the same permutation as

    1. one all-to-all over the device tier (the whole payload, within a host),
    2. H - 1 point-to-point hops over the host tier, hop k sending to host
       h + k the sub-block meant for it: 1/H of the flat payload each, and
       the sub-block that stays on this host is sliced out locally, never
       sent, and
    3. a local reorder of the received sub-blocks by source rank
       (:func:`_hier_reorder`),

so the inter-host bytes are (H - 1)/H of the flat exchange's and the result
is bit-equal to it at fp32 wires.  ``wire_dtype`` demotes the intra-host
all-to-all as on a flat mesh; ``inter_wire_dtype`` demotes the inter-host
hops alone, through the same ``wire_pack`` kernels.  :data:`WIRE_BYTES`
counts the bytes this rank hands to each tier.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.wire_pack.ops import pack_wire, unpack_wire
from ..kernels.wire_pack.ref import pack_geometry, unpack_geometry
from ..ops.spectral import half_to_full, padded_rfft_len, rfft_len  # noqa: F401
from .compat import MODEL_AXIS, gather_cat

# bytes this rank handed to each tier's collectives since the last reset:
# "flat" a transpose all-to-all over one axis (or a factored pair), "intra"
# the device-tier all-to-all of the two-stage exchange, "inter" its
# host-tier hops
WIRE_BYTES = {"flat": 0, "intra": 0, "inter": 0}


def reset_wire_bytes() -> None:
    for tier in WIRE_BYTES:
        WIRE_BYTES[tier] = 0

# --------------------------------------------------------------------------
# layout: flat <-> (n1, n2), and this rank's blocks of it
# --------------------------------------------------------------------------


def layout_2d(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Flat signal (..., n) -> four-step layout (..., n1, n2), a view.

    ``A[j1, j2] = x[j1 + n1*j2]``: consecutive samples run down the columns,
    so a rank's rows are a strided 1/p subset of the signal.
    """
    return x.reshape(x.shape[:-1] + (n2, n1)).transpose(-1, -2)


def unlayout_2d(a: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`layout_2d`: (..., n1, n2) -> (..., n)."""
    n1, n2 = a.shape[-2], a.shape[-1]
    return a.transpose(-1, -2).reshape(a.shape[:-2] + (n1 * n2,))


def freq_flat(F2: torch.Tensor) -> torch.Tensor:
    """Spectrum layout -> natural DFT order: ``X[n2*k1 + k2] = F[k1, k2]``."""
    return F2.reshape(F2.shape[:-2] + (F2.shape[-2] * F2.shape[-1],))


def row_block(a: torch.Tensor, mesh, axis_name=MODEL_AXIS) -> torch.Tensor:
    """This rank's rows of a global (..., n1, n2) signal-domain array."""
    p, idx = mesh.size(axis_name), mesh.index(axis_name)
    r = a.shape[-2] // p
    return a[..., idx * r:(idx + 1) * r, :].contiguous()


def col_block(a: torch.Tensor, mesh, axis_name=MODEL_AXIS) -> torch.Tensor:
    """This rank's columns of a global (..., n1, c) spectrum-domain array."""
    p, idx = mesh.size(axis_name), mesh.index(axis_name)
    c = a.shape[-1] // p
    return a[..., idx * c:(idx + 1) * c].contiguous()


def gather_rows(a: torch.Tensor, mesh, axis_name=MODEL_AXIS) -> torch.Tensor:
    """All ranks' row blocks -> the global (..., n1, n2) array, on every rank."""
    return gather_cat(a, mesh.group(axis_name), dim=-2, order=mesh.group_order(axis_name))


# --------------------------------------------------------------------------
# twiddles, chunking and the transpose all-to-all
# --------------------------------------------------------------------------


def _phase(num: torch.Tensor, n: int) -> torch.Tensor:
    """exp(-2*pi*i * num / n) with the int64 exponent reduced mod n before
    the float32 divide (an int32 product overflows past 2^31, a float32 one
    is inexact past 2^24)."""
    ang = (-2.0 * math.pi) * ((num % n).to(torch.float32) / n)
    return torch.complex(torch.cos(ang), torch.sin(ang))


@functools.lru_cache(maxsize=64)
def _twiddle(j1_0: int, rows: int, k2_0: int, cols: int, n: int, inverse: bool,
             device: torch.device) -> torch.Tensor:
    """W_n^{±j1*k2} over global rows [j1_0, j1_0 + rows) and columns
    [k2_0, k2_0 + cols): built once for a block and reused by every call."""
    j1 = torch.arange(j1_0, j1_0 + rows, dtype=torch.int64, device=device)
    k2 = torch.arange(k2_0, k2_0 + cols, dtype=torch.int64, device=device)
    num = j1[:, None] * k2[None, :]
    return _phase(-num if inverse else num, n)


def _twiddled(b: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """``b * tw`` written contiguous: the first stage of every transform.
    cuFFT may return a transform over a leading axis in a transposed layout,
    which a plain product would keep; the wire pack takes contiguous
    payloads, so the product lays it out in the same pass."""
    return torch.mul(b, tw, out=torch.empty(b.shape, dtype=b.dtype, device=b.device))


def _chunk_grid(extent: int, overlap: int) -> Tuple[int, int]:
    """(chunk_size, n_chunks) cutting ``extent`` into ~``overlap`` equal
    chunks (the last one zero-padded up to chunk_size by the caller)."""
    k = max(1, min(int(overlap), extent))
    cs = -(-extent // k)
    return cs, -(-extent // cs)


def _pad_to(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    extra = size - x.shape[axis]
    if extra == 0:
        return x
    pads = [0, 0] * (-axis)
    pads[-1] = extra  # F.pad's pairs run from the last axis backwards
    return F.pad(x, pads)


def _wire_all_to_all(t: torch.Tensor, mesh, axis_name, split_off: int, concat_off: int,
                     wire_dtype: str, async_op: bool = False, tier: str = "flat"):
    """Issue one transpose all-to-all of ``t``; -> a function that waits for
    it and returns the received payload.

    As ``lax.all_to_all(split_axis, concat_axis, tiled=True)``: axis
    ``-split_off`` is cut into p chunks, chunk j goes to the rank holding
    block j, and what arrives is concatenated along axis ``-concat_off`` in
    source-block order.  ``all_to_all_single`` splits dim 0 only, so the
    chunks are laid out rank-major first: by ``pack_wire(groups=p)`` in the
    same pass as the demotion, or by a copy for the float32 wire.  On a
    factored (host, device) axis the chunks are put in group-rank order
    before the exchange and back in block order after it
    (:meth:`~repro_torch.dist.compat.Mesh.group_order`).
    """
    group, p = mesh.group(axis_name), mesh.size(axis_name)
    order = mesh.group_order(axis_name)
    o, i, chunk = pack_geometry(t.shape, p, t.ndim - split_off)
    if wire_dtype == "fp32":
        send = torch.view_as_real(t.reshape(o, p, i).transpose(0, 1).contiguous())
    else:
        send = pack_wire(t, wire_dtype, groups=p, axis=t.ndim - split_off)
    if order is not None:
        send = send.index_select(0, torch.tensor(order, device=send.device))
    recv = torch.empty_like(send)
    WIRE_BYTES[tier] += send.nbytes
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)
    concat_axis = len(chunk) - concat_off

    def finish() -> torch.Tensor:
        r = recv
        if work is not None:
            work.wait()
        if order is not None:
            by_block = [0] * p
            for g, block in enumerate(order):
                by_block[block] = g
            r = r.index_select(0, torch.tensor(by_block, device=r.device))
        if wire_dtype != "fp32":
            return unpack_wire(r, t.dtype, grouped=True, axis=concat_axis)
        o2, i2, out_shape = unpack_geometry(chunk, p, concat_axis)
        r = torch.view_as_complex(r).reshape(p, o2, i2)
        return r.transpose(0, 1).reshape(out_shape)

    return finish


def _host_hops(sends, mesh, host_axis: str, wire_dtype: str) -> list:
    """The inter-host hops of the two-stage exchange: ``sends[k - 1]`` goes
    to host h + k and what host h - k sent comes back, k = 1 .. H - 1, all
    in one batch of point-to-point operations; -> the received pieces.

    Demoted payloads travel as ``wire_pack`` planes in their own dtype.  A
    gloo group carries CUDA tensors in its collectives but not in
    point-to-point operations, so there a hop is staged through the host.
    """
    if not sends:  # one host: nothing crosses
        return []
    group, H, h = mesh.group(host_axis), mesh.size(host_axis), mesh.index(host_axis)
    bufs = [torch.view_as_real(s.contiguous()) if wire_dtype == "fp32"
            else pack_wire(s.contiguous(), wire_dtype) for s in sends]
    # never on meta (a dry run), whose fake group is not gloo
    staged = bufs[0].is_cuda and dist.get_backend(group) == "gloo"
    wire = [b.cpu() if staged else b for b in bufs]
    recvs = [torch.empty_like(b) for b in wire]
    ops = []
    for k, (out, into) in enumerate(zip(wire, recvs), start=1):
        WIRE_BYTES["inter"] += out.nbytes
        ops.append(dist.P2POp(dist.isend, out, dist.get_global_rank(group, (h + k) % H), group))
        ops.append(dist.P2POp(dist.irecv, into, dist.get_global_rank(group, (h - k) % H), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = []
    for r, like in zip(recvs, sends):
        r = r.to(bufs[0].device) if staged else r
        out.append(torch.view_as_complex(r) if wire_dtype == "fp32"
                   else unpack_wire(r, like.dtype))
    return out


def _hier_reorder(pieces, h: int) -> torch.Tensor:
    """Order the hop pieces by source host and stack them on axis -3.

    ``pieces[k]`` came from host ``(h - k) % H`` (k = 0 is the local
    sub-block), so source host s is piece ``(h - s) % H``: the reference's
    static flip ``R'[j] = R[(-j) % H]`` followed by a roll by ``h``, which
    the port, whose ``h`` is a plain number, does as one list reindex.
    """
    H = len(pieces)
    return torch.stack([pieces[(h - s) % H] for s in range(H)], dim=-3)


def _hier_fwd_exchange(t: torch.Tensor, mesh, axis_name, wire_dtype: str,
                       inter_wire_dtype: str, async_op: bool = False):
    """Two-stage forward transpose: (..., cs, W) -> (..., p*cs, W/p), the
    flat all-to-all over the factored axis, bit-equal at fp32 wires.  Stage
    1 is an all-to-all over the device tier (issued now, ``async_op``);
    stage 2 sends only the H - 1 cross-host sub-blocks.  -> a function that
    finishes the exchange and returns the result."""
    host, dev = axis_name
    H, D, h = mesh.size(host), mesh.size(dev), mesh.index(host)
    intra = _wire_all_to_all(t, mesh, dev, 1, 2, wire_dtype, async_op, tier="intra")

    def finish() -> torch.Tensor:
        a = intra()  # (..., D*cs, W/D)
        w = a.shape[-1] // H
        sub = lambda g: a[..., g * w:(g + 1) * w]
        # the sub-block staying on this host is sliced out here, never sent
        pieces = [sub(h)] + _host_hops([sub((h + k) % H) for k in range(1, H)], mesh, host,
                                       inter_wire_dtype)
        T = _hier_reorder(pieces, h)  # (..., H, D*cs, w)
        cs = T.shape[-2] // D
        T = T.reshape(T.shape[:-2] + (D, cs, w)).transpose(-4, -3)  # (..., D, H, cs, w)
        return T.reshape(T.shape[:-4] + (D * H * cs, w))

    return finish


def _hier_inv_exchange(t: torch.Tensor, mesh, axis_name, wire_dtype: str,
                       inter_wire_dtype: str, async_op: bool = False):
    """Two-stage inverse transpose: (..., n1, cs) -> (..., n1/p, p*cs); the
    mirror of :func:`_hier_fwd_exchange` (rows cross the wire, columns
    concatenate)."""
    host, dev = axis_name
    H, D, h = mesh.size(host), mesh.size(dev), mesh.index(host)
    intra = _wire_all_to_all(t, mesh, dev, 2, 1, wire_dtype, async_op, tier="intra")

    def finish() -> torch.Tensor:
        a = intra()  # (..., n1/D, D*cs)
        r = a.shape[-2] // H
        sub = lambda g: a[..., g * r:(g + 1) * r, :]
        pieces = [sub(h)] + _host_hops([sub((h + k) % H) for k in range(1, H)], mesh, host,
                                       inter_wire_dtype)
        T = _hier_reorder(pieces, h)  # (..., H, n1/p, D*cs)
        cs = T.shape[-1] // D
        T = T.reshape(T.shape[:-1] + (D, cs)).movedim(-4, -2)  # (..., n1/p, D, H, cs)
        return T.reshape(T.shape[:-3] + (D * H * cs,))

    return finish


def _exchange(t: torch.Tensor, mesh, axis_name, split_off: int, concat_off: int,
              wire_dtype: str, hier: bool, inter_wire_dtype: str, async_op: bool = False):
    """One transpose: the two-stage exchange on a hierarchical plan's
    (host, device) pair, else one all-to-all (over a factored pair too)."""
    if hier and not isinstance(axis_name, str):
        two_stage = _hier_fwd_exchange if split_off == 1 else _hier_inv_exchange
        return two_stage(t, mesh, axis_name, wire_dtype, inter_wire_dtype, async_op)
    return _wire_all_to_all(t, mesh, axis_name, split_off, concat_off, wire_dtype, async_op)


def _fwd_transpose(stage1, a: torch.Tensor, overlap: int, mesh, axis_name, wire_dtype: str,
                   hier: bool = False, inter_wire_dtype: str = "fp32") -> torch.Tensor:
    """Forward transpose with the row axis (-2) chunked.

    ``stage1(chunk, r0)`` maps rows [r0, r0 + rows) of the local block to
    their twiddled first-stage output (..., rows, W), W divisible by p.
    Returns (..., p * n1_loc, W / p), the same as one whole exchange.
    """
    n1_loc = a.shape[-2]
    if overlap <= 1:
        return _exchange(stage1(a, 0), mesh, axis_name, 1, 2, wire_dtype, hier,
                         inter_wire_dtype)()
    cs, nch = _chunk_grid(n1_loc, overlap)
    pending = []
    for i in range(nch):
        # pad rows are zero and stay zero through the row FFT and the twiddle
        t = _pad_to(stage1(a[..., i * cs: min((i + 1) * cs, n1_loc), :], i * cs), cs, -2)
        pending.append(_exchange(t, mesh, axis_name, 1, 2, wire_dtype, hier,
                                 inter_wire_dtype, async_op=True))
    return _gather_fwd_chunks([f() for f in pending], mesh.size(axis_name), cs, n1_loc)


def _gather_fwd_chunks(outs, p: int, cs: int, n1_loc: int) -> torch.Tensor:
    """Chunk i's output (..., p*cs, w) holds rows peer-major (peer d's rows
    [i*cs, (i+1)*cs)); interleave the chunks per peer, drop the pad rows."""
    w = outs[0].shape[-1]
    st = torch.stack(outs, dim=-3)  # (..., K, p*cs, w)
    st = st.reshape(st.shape[:-2] + (p, cs, w)).transpose(-4, -3)  # (..., p, K, cs, w)
    st = st.reshape(st.shape[:-3] + (st.shape[-3] * cs, w))[..., :n1_loc, :]
    return st.reshape(st.shape[:-3] + (p * n1_loc, w))


def _inv_transpose(stage1, F2: torch.Tensor, overlap: int, mesh, axis_name, wire_dtype: str,
                   hier: bool = False, inter_wire_dtype: str = "fp32") -> torch.Tensor:
    """Inverse transpose with the column axis (-1) chunked.

    ``stage1(chunk, c0)`` maps columns [c0, c0 + cols) of the local
    spectrum block to their twiddled first-stage output (..., n1, cols).
    Returns (..., n1 / p, p * c_loc), the same as one whole exchange.
    """
    c_loc = F2.shape[-1]
    if overlap <= 1:
        return _exchange(stage1(F2, 0), mesh, axis_name, 2, 1, wire_dtype, hier,
                         inter_wire_dtype)()
    cs, nch = _chunk_grid(c_loc, overlap)
    pending = []
    for i in range(nch):
        t = _pad_to(stage1(F2[..., i * cs: min((i + 1) * cs, c_loc)], i * cs), cs, -1)
        pending.append(_exchange(t, mesh, axis_name, 2, 1, wire_dtype, hier,
                                 inter_wire_dtype, async_op=True))
    return _gather_inv_chunks([f() for f in pending], mesh.size(axis_name), cs, c_loc)


def _gather_inv_chunks(outs, p: int, cs: int, c_loc: int) -> torch.Tensor:
    """Chunk i's output (..., R, p*cs) holds columns peer-major; interleave
    the chunks per peer and drop the pad columns."""
    st = torch.stack(outs, dim=-2)  # (..., R, K, p*cs)
    st = st.reshape(st.shape[:-1] + (p, cs)).transpose(-3, -2)  # (..., R, p, K, cs)
    st = st.reshape(st.shape[:-2] + (st.shape[-2] * cs,))[..., :c_loc]
    return st.reshape(st.shape[:-2] + (p * c_loc,))


# --------------------------------------------------------------------------
# per-rank transforms
# --------------------------------------------------------------------------


def fft2_local(a: torch.Tensor, mesh, axis_name=MODEL_AXIS, overlap: int = 1,
               wire_dtype: str = "fp32", hier: bool = False,
               inter_wire_dtype: str = "fp32") -> torch.Tensor:
    """Forward four-step FFT of this rank's rows.

    a: (..., n1/p, n2) complex.  Returns (..., n1, n2/p): this rank's
    columns of the spectrum.
    """
    p, idx = mesh.size(axis_name), mesh.index(axis_name)
    n1_loc, n2 = a.shape[-2], a.shape[-1]
    tw = _twiddle(idx * n1_loc, n1_loc, 0, n2, n1_loc * p * n2, False, a.device)

    def stage1(chunk, r0):
        return _twiddled(torch.fft.fft(chunk, dim=-1), tw[r0: r0 + chunk.shape[-2]])

    b = _fwd_transpose(stage1, a, overlap, mesh, axis_name, wire_dtype, hier,
                       inter_wire_dtype)
    return torch.fft.fft(b, dim=-2)


def ifft2_local(F2: torch.Tensor, mesh, axis_name=MODEL_AXIS, overlap: int = 1,
                wire_dtype: str = "fp32", hier: bool = False,
                inter_wire_dtype: str = "fp32") -> torch.Tensor:
    """Inverse four-step FFT of this rank's spectrum columns.

    F2: (..., n1, n2/p) complex.  Returns (..., n1/p, n2): this rank's rows,
    complex (take the real part for a real signal).
    """
    p, idx = mesh.size(axis_name), mesh.index(axis_name)
    n1, n2_loc = F2.shape[-2], F2.shape[-1]
    tw = _twiddle(0, n1, idx * n2_loc, n2_loc, n1 * n2_loc * p, True, F2.device)

    def stage1(chunk, c0):
        return _twiddled(torch.fft.ifft(chunk, dim=-2), tw[:, c0: c0 + chunk.shape[-1]])

    b = _inv_transpose(stage1, F2, overlap, mesh, axis_name, wire_dtype, hier,
                       inter_wire_dtype)
    return torch.fft.ifft(b, dim=-1)


def rfft2_local(a: torch.Tensor, mesh, axis_name=MODEL_AXIS, overlap: int = 1,
                wire_dtype: str = "fp32", hier: bool = False,
                inter_wire_dtype: str = "fp32") -> torch.Tensor:
    """Forward four-step rfft of this rank's *real* rows.

    a: (..., n1/p, n2) real.  Returns (..., n1, pad(nf)/p) complex: this
    rank's columns of the half spectrum (k2 in [0, n2//2], zero-padded to
    a multiple of p).
    """
    p, idx = mesh.size(axis_name), mesh.index(axis_name)
    n1_loc, n2 = a.shape[-2], a.shape[-1]
    nf, nf_pad = rfft_len(n2), padded_rfft_len(n2, p)
    tw = _twiddle(idx * n1_loc, n1_loc, 0, nf, n1_loc * p * n2, False, a.device)

    def stage1(chunk, r0):
        return _pad_to(_twiddled(torch.fft.rfft(chunk, dim=-1), tw[r0: r0 + chunk.shape[-2]]),
                       nf_pad, -1)

    b = _fwd_transpose(stage1, a, overlap, mesh, axis_name, wire_dtype, hier,
                       inter_wire_dtype)
    return torch.fft.fft(b, dim=-2)


def irfft2_local(F2: torch.Tensor, n2: int, mesh, axis_name=MODEL_AXIS,
                 overlap: int = 1, wire_dtype: str = "fp32", hier: bool = False,
                 inter_wire_dtype: str = "fp32") -> torch.Tensor:
    """Inverse four-step rfft of this rank's half-spectrum columns.

    F2: (..., n1, pad(nf)/p) complex; ``n2`` is the signal's column count
    (not recoverable from the half layout).  Returns this rank's real rows
    (..., n1/p, n2).
    """
    idx = mesh.index(axis_name)
    n1, nfp_loc = F2.shape[-2], F2.shape[-1]
    tw = _twiddle(0, n1, idx * nfp_loc, nfp_loc, n1 * n2, True, F2.device)

    def stage1(chunk, c0):
        return _twiddled(torch.fft.ifft(chunk, dim=-2), tw[:, c0: c0 + chunk.shape[-1]])

    b = _inv_transpose(stage1, F2, overlap, mesh, axis_name, wire_dtype, hier,
                       inter_wire_dtype)
    return torch.fft.irfft(b[..., :rfft_len(n2)], n=n2, dim=-1)


def matvec_local(spec: torch.Tensor, x: torch.Tensor, mesh, axis_name=MODEL_AXIS,
                 transpose: bool = False, overlap: int = 1, wire_dtype: str = "fp32",
                 hier: bool = False, inter_wire_dtype: str = "fp32") -> torch.Tensor:
    """Circulant matvec on this rank's blocks: Re ifft2(spec * fft2(x)).

    spec: this rank's spectrum columns (..., n1, n2/p); x: its real rows
    (..., n1/p, n2).  ``transpose=True`` applies C^T (conjugate spectrum).
    """
    kw = dict(overlap=overlap, wire_dtype=wire_dtype, hier=hier,
              inter_wire_dtype=inter_wire_dtype)
    f = fft2_local(x.to(spec.dtype), mesh, axis_name, **kw)
    s = spec.conj() if transpose else spec
    return ifft2_local(s * f, mesh, axis_name, **kw).real


def rmatvec_local(spec_h: torch.Tensor, x: torch.Tensor, mesh, axis_name=MODEL_AXIS,
                  transpose: bool = False, overlap: int = 1, wire_dtype: str = "fp32",
                  hier: bool = False, inter_wire_dtype: str = "fp32") -> torch.Tensor:
    """Half-spectrum circulant matvec: :func:`matvec_local`'s contract with
    ``spec_h`` this rank's half-spectrum columns.  The product of Hermitian
    spectra is Hermitian, so the half layout closes under the multiply."""
    kw = dict(overlap=overlap, wire_dtype=wire_dtype, hier=hier,
              inter_wire_dtype=inter_wire_dtype)
    f = rfft2_local(x, mesh, axis_name, **kw)
    s = spec_h.conj() if transpose else spec_h
    return irfft2_local(s * f, x.shape[-1], mesh, axis_name, **kw)


# --------------------------------------------------------------------------
# factories (the reference's shard_map entry points, over local blocks)
# --------------------------------------------------------------------------


def make_distributed_fft(mesh, axis_name=MODEL_AXIS, overlap: int = 1,
                         wire_dtype: str = "fp32", hier: bool = False,
                         inter_wire_dtype: str = "fp32"):
    """(fft2d, ifft2d) on this rank's blocks: rows -> spectrum columns and
    back, one transpose each (``overlap=K`` chunks it; ``hier=True`` on a
    (host, device) ``axis_name`` runs it as the two-stage exchange)."""
    kw = dict(mesh=mesh, axis_name=axis_name, overlap=overlap, wire_dtype=wire_dtype,
              hier=hier, inter_wire_dtype=inter_wire_dtype)
    return functools.partial(fft2_local, **kw), functools.partial(ifft2_local, **kw)


def make_distributed_rfft(mesh, n2: int, axis_name=MODEL_AXIS, overlap: int = 1,
                          wire_dtype: str = "fp32", hier: bool = False,
                          inter_wire_dtype: str = "fp32"):
    """(rfft2d, irfft2d): half-spectrum transforms of this rank's real rows."""
    kw = dict(mesh=mesh, axis_name=axis_name, overlap=overlap, wire_dtype=wire_dtype,
              hier=hier, inter_wire_dtype=inter_wire_dtype)
    return functools.partial(rfft2_local, **kw), functools.partial(irfft2_local, n2=n2, **kw)


def make_distributed_matvec(mesh, axis_name=MODEL_AXIS, rfft: bool = False,
                            overlap: int = 1, wire_dtype: str = "fp32", hier: bool = False,
                            inter_wire_dtype: str = "fp32"):
    """``mv(spec_block, x_rows, transpose=False)``: two transposes per call;
    ``rfft=True`` takes the half-spectrum columns."""
    local = rmatvec_local if rfft else matvec_local

    def mv(spec: torch.Tensor, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        return local(spec, x, mesh, axis_name, transpose, overlap, wire_dtype, hier,
                     inter_wire_dtype)

    return mv
