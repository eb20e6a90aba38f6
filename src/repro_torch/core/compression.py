"""Compressive-sensing gradient compression for a slow all-reduce.

Port of ``repro/core/compression.py``: the paper's sensing/recovery pair as
a collective for distributed optimisation.  Compressed sensing moves the
encoding cost from the sender to the receiver, which is what a slow link
wants: every rank can afford an O(n log n) rFFT, the wire cannot afford n
floats.

Per gradient leaf and step:

    e   = g + residual               # error feedback (Karimireddy et al. '19)
    y   = P C e                      # partial-circulant projection, via rFFT
    y~  = all-reduce mean of y       # m = n/ratio floats on the wire
    g^  = k FISTA steps on (PC, y~)  # decode: paper Alg. 1, fixed k
    residual = e - g^                # local feedback memory

The sensing operator comes from a seed, so every rank builds the same
operator with no coordination.  The compression is lossy; error feedback
keeps SGD/Adam convergent.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..dist.compat import DATA_AXIS
from ..ops.prox import L1Prox
from .circulant import Circulant, PartialCirculant, random_omega, romberg_circulant

_L1 = L1Prox()  # the decode default: the paper's soft threshold, through the prox layer


class CompressorSpec(NamedTuple):
    """The compressor's static description."""

    n: int  # padded flat length
    m: int  # measurement count
    decode_iters: int  # FISTA steps at the receiver
    alpha: float  # decode threshold weight
    prox: Any = None  # decode prior (repro_torch.ops.prox); None = l1 soft threshold


class CompressorState(NamedTuple):
    """Per-leaf operator constants and the error-feedback memory."""

    col: torch.Tensor  # (n,) circulant first column (unit spectrum)
    omega: torch.Tensor  # (m,) selected rows
    residual: torch.Tensor  # (n,) error feedback


def make_compressor(
    gen: torch.Generator,
    dim: int,
    ratio: int = 8,
    decode_iters: int = 50,
    alpha: float = 3e-3,
    prox=None,
    device=None,
) -> Tuple[CompressorSpec, CompressorState]:
    """``ratio`` = n/m, the compression factor on the wire; ``prox=`` the
    decode prior (None = the l1 soft threshold).  The Romberg sensing
    circulant and then the rows are drawn from ``gen``: the same seed gives
    every rank the same operator."""
    n = max(8, 1 << (max(dim, 2) - 1).bit_length())  # pad to a power of two for the FFT
    m = max(1, n // ratio)
    device = resolve_device(device)
    # Romberg unit-spectrum sensing: orthogonal rows, so FISTA's tau = 1 is safe
    circ = romberg_circulant(gen, n, device=device)
    omega = random_omega(gen, n, m, device=device)
    spec = CompressorSpec(n=n, m=m, decode_iters=decode_iters, alpha=alpha, prox=prox)
    state = CompressorState(col=circ.col, omega=omega,
                            residual=torch.zeros(n, dtype=torch.float32, device=device))
    return spec, state


def _op(state: CompressorState) -> PartialCirculant:
    return PartialCirculant(Circulant.from_first_col(state.col), state.omega)


def compress(spec: CompressorSpec, state: CompressorState,
             g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (measurements y, error-feedback input e); ``g`` is any shape of
    ``dim`` elements."""
    flat = g.reshape(-1).to(torch.float32)
    e = F.pad(flat, (0, spec.n - flat.shape[0])) + state.residual
    return _op(state).matvec(e), e


def decode(spec: CompressorSpec, state: CompressorState, y: torch.Tensor) -> torch.Tensor:
    """Fixed-k FISTA decode (accelerated paper Alg. 1; tau = 1 is safe for
    the Romberg operator's orthogonal rows)."""
    op = _op(state)
    prox = spec.prox if spec.prox is not None else _L1
    x = x_prev = y.new_zeros(spec.n)
    t = y.new_ones(())
    for _ in range(spec.decode_iters):
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        v = x + ((t - 1.0) / t_next) * (x - x_prev)
        r = y - op.matvec(v)
        x, x_prev, t = prox.apply(v + op.rmatvec(r), spec.alpha), x, t_next
    return x


def update_residual(state: CompressorState, e: torch.Tensor,
                    g_hat: torch.Tensor) -> CompressorState:
    return state._replace(residual=e - g_hat)


def compressed_mean(spec: CompressorSpec, state: CompressorState, g: torch.Tensor, mesh,
                    axis_name: str = DATA_AXIS) -> Tuple[torch.Tensor, CompressorState]:
    """The mean of ``g`` over the mesh axis ``axis_name``, m floats on the
    wire instead of n: compress, all-reduce the measurements, decode.  Every
    rank of the axis calls it.  -> (decoded mean gradient, new state).

    gloo has no average all-reduce, so the sum is divided by the axis size.
    """
    dim = g.numel()
    y, e = compress(spec, state, g)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group(axis_name))
    y = y / mesh.size(axis_name)
    g_hat = decode(spec, state, y)
    new_state = update_residual(state, e, g_hat)
    return g_hat[:dim].reshape(g.shape).to(g.dtype), new_state


def compression_wire_bytes(spec: CompressorSpec) -> int:
    return spec.m * 4


def identity_wire_bytes(dim: int) -> int:
    return dim * 4
