"""Deterministic synthetic data: k-sparse signals, starfield and extended-emission
images, tokens.

Port of the recovery half of ``repro/data/synthetic.py`` and its LM token
stream.  Each function
takes a ``torch.Generator`` in place of the reference's ``jax.random`` key
and draws on the generator's device, then places the result on
``device=`` (``None`` = the CUDA default).  The two packages give different
numbers from the same seed; parity tests build their inputs once and hand
them to both.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..device import resolve_device


def sparse_signal(
    gen: torch.Generator, n: int, k: int, batch: Tuple[int, ...] = (),
    dtype=torch.float32, device=None,
) -> torch.Tensor:
    """x* with exactly k nonzeros per signal, values ~ N(0,1) (paper Sec. 6)."""
    device = resolve_device(device)
    vals = torch.randn(batch + (n,), generator=gen, dtype=dtype, device=gen.device)
    masks = torch.zeros(math.prod(batch), n, dtype=dtype, device=gen.device)
    for row in masks:
        row[torch.randperm(n, generator=gen, device=gen.device)[:k]] = 1.0
    return (vals * masks.reshape(batch + (n,))).to(device)


def paper_regime(n: int) -> Tuple[int, int]:
    """Paper Sec. 6: m = n/2 measurements, k ~= n/10 nonzeros."""
    return n // 2, max(1, n // 10)


def starfield(
    gen: torch.Generator,
    h: int = 256,
    w: int = 256,
    density: float = 0.10,
    n_blobs: int = 12,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Sparse night-sky image (the paper's Abell-2744 stand-in): point
    sources (~``density`` of pixels lit) plus a few soft elliptical blobs
    standing in for cluster galaxies.  Intensities in [0, 1]."""
    device = resolve_device(device)
    draw = dict(generator=gen, dtype=dtype, device=gen.device)
    lit = torch.rand(h, w, **draw) < density
    intensity = 0.2 + 0.8 * torch.rand(h, w, **draw)
    params = torch.rand(n_blobs, 5, **draw).tolist()  # cy cx sy sx amp
    img = torch.where(lit, intensity, torch.zeros_like(intensity)).to(device)

    yy = torch.arange(h, dtype=dtype, device=device)[:, None]
    xx = torch.arange(w, dtype=dtype, device=device)[None, :]
    for p_cy, p_cx, p_sy, p_sx, p_amp in params:
        cy, cx = p_cy * h, p_cx * w
        sy = 1.5 + p_sy * (h / 40.0)
        sx = 1.5 + p_sx * (w / 40.0)
        amp = 0.3 + 0.7 * p_amp
        img = img + amp * torch.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
    img = img.clamp(0.0, 1.0)
    # Kill sub-perceptual blob tails so the image stays genuinely sparse
    # (the paper's premise: most night-sky pixels are black).
    return torch.where(img < 0.02, torch.zeros_like(img), img)


def extended_emission(
    gen: torch.Generator,
    h: int = 256,
    w: int = 256,
    n_sources: int = 3,
    background: float = 0.05,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Piecewise-constant extended-emission map (a Herschel-style dust or
    cloud field): ``n_sources`` flat-topped disks of random centre, radius
    and intensity over a faint uniform background.  The complement of
    :func:`starfield`: almost nowhere zero but gradient-sparse, the regime
    where the TV prior (``repro_torch.ops.prox.TVProx``) beats the paper's
    l1 threshold.  Intensities in [0, 1]."""
    device = resolve_device(device)
    params = torch.rand(n_sources, 4, generator=gen, dtype=dtype, device=gen.device)
    return _paint_disks(params.to(device), h, w, background)


def _paint_disks(params: torch.Tensor, h: int, w: int, background: float) -> torch.Tensor:
    """The disks of :func:`extended_emission` from its (n_sources, 4) draws in
    [0, 1) (centre y, centre x, radius, intensity), painted in order in the
    draws' dtype and on their device.

    The reference's compiler fuses each ``a + b * p`` into one multiply-add,
    rounded once; the same sum of the constants in the draws' dtype, formed
    in float64 and rounded back, gives its numbers bit for bit."""
    dtype, device = params.dtype, params.device
    yy = torch.arange(h, dtype=dtype, device=device)[:, None]
    xx = torch.arange(w, dtype=dtype, device=device)[None, :]
    img = torch.full((h, w), background, dtype=dtype, device=device)
    as_dtype = lambda v: float(torch.tensor(v, dtype=dtype))
    fused = lambda a, b, q: (as_dtype(a) + as_dtype(b) * q.double()).to(dtype)
    for p in params:
        cy, cx = p[0] * h, p[1] * w
        r = fused(0.10, 0.18, p[2]) * min(h, w)
        amp = fused(0.4, 0.6, p[3])
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img = torch.where(inside, torch.maximum(img, amp), img)
    return img.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# LM substrate: token streams
# ---------------------------------------------------------------------------


def token_batch(gen: torch.Generator, batch: int, seq_len: int, vocab: int,
                device=None) -> torch.Tensor:
    """(batch, seq_len + 1) int64 tokens in [0, vocab), as the reference's
    ``token_batch``: a mixture of a low-id head (ids below max(2, vocab //
    64), drawn with probability 0.8) and a uniform tail, so the marginal is
    Zipf-ish.  Drawn from ``gen`` on its device, then placed on ``device``."""
    device = resolve_device(device)
    shape = (batch, seq_len + 1)
    head = torch.randint(0, max(2, vocab // 64), shape, generator=gen, device=gen.device)
    tail = torch.randint(0, vocab, shape, generator=gen, device=gen.device)
    pick_head = torch.rand(shape, generator=gen, device=gen.device) < 0.8
    return torch.where(pick_head, head, tail).to(device)
