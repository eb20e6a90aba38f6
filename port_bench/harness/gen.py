"""Seeded inputs: operators, signals, frames, contracts and arrival times.

The benchmark's own generators.  Every draw of a run comes from ``--seed``
through a named stream (:func:`stream`), so one seed gives one set of
inputs, and two streams never share draws.  The operator is the
deployment's instrument: it comes from the configuration's
``operator_seed`` (:func:`operator_stream`), the same for every run, so a
seed changes the signals and their order but not how fast the operator
lets them converge.  Everything large is drawn on
the device in a few batched calls.  Measurements are computed here, in
float64, from the float32 operator that both the program and the reference
are handed, and rounded to float32 once.

Imports torch and numpy only: nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_STREAMS = ("operator", "data", "contracts", "arrivals", "sample")


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run ``seed``."""
    state = np.random.SeedSequence([int(seed), _STREAMS.index(name)]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def stream(seed: int, name: str, device) -> torch.Generator:
    """A torch generator on ``device`` for the stream ``name``."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name))


def operator_stream(cfg: dict, device) -> torch.Generator:
    """The generator of the configuration's operator, from its ``operator_seed``."""
    return stream(cfg["operator_seed"], "operator", device)


def rng(seed: int, name: str) -> np.random.Generator:
    """A numpy generator for the host-side stream ``name``."""
    return np.random.default_rng(stream_seed(seed, name))


def row_to_col(row: torch.Tensor) -> torch.Tensor:
    """First row -> first column of a circulant: col[i] = row[(-i) mod n]."""
    return torch.roll(torch.flip(row, dims=(-1,)), 1, dims=-1)


def random_omega(gen: torch.Generator, n: int, m: int) -> torch.Tensor:
    """A sorted random m-subset of range(n), int64, on the generator's device."""
    return torch.sort(torch.randperm(n, generator=gen, device=gen.device)[:m]).values


def gaussian_partial_circulant(gen: torch.Generator, n: int, m: int, normalize: bool):
    """Paper Sec. 6: first row i.i.d. N(0, 1), optionally scaled to unit
    spectral norm; -> (col float32, omega int64)."""
    row = torch.randn(n, generator=gen, device=gen.device, dtype=torch.float64)
    col = row_to_col(row)
    if normalize:
        col = col / torch.fft.rfft(col).abs().max()
    return col.float(), random_omega(gen, n, m)


def romberg_blur_partial_circulant(gen: torch.Generator, n: int, m: int, blur_order: int):
    """Paper Sec. 7: romberg sensing (unit-modulus spectrum, random phase,
    real DC and Nyquist bins) composed with the order-L raster moving
    average; -> (col float32 of the joint C B, omega int64)."""
    nf = n // 2 + 1
    phase = torch.rand(nf, generator=gen, device=gen.device, dtype=torch.float64)
    sense = torch.polar(torch.ones_like(phase), phase * (2 * math.pi))
    sense[0] = 1.0
    if n % 2 == 0:
        sense[-1] = 1.0
    blur_row = torch.zeros(n, device=gen.device, dtype=torch.float64)
    blur_row[:blur_order] = 1.0 / blur_order
    blur = torch.fft.rfft(row_to_col(blur_row))
    col = torch.fft.irfft(sense * blur, n=n)
    return col.float(), random_omega(gen, n, m)


def sparse_signals(gen: torch.Generator, count: int, n: int, k: int) -> torch.Tensor:
    """(count, n) float64 signals with exactly k N(0, 1) nonzeros each."""
    support = torch.rand(count, n, generator=gen, device=gen.device).argsort(dim=1)[:, :k]
    vals = torch.randn(count, k, generator=gen, device=gen.device, dtype=torch.float64)
    x = torch.zeros(count, n, device=gen.device, dtype=torch.float64)
    return x.scatter_(1, support, vals)


def starfields(gen: torch.Generator, count: int, h: int, w: int, density: float,
               n_blobs: int) -> torch.Tensor:
    """(count, h, w) float64 night-sky frames in [0, 1]: point sources on
    ~``density`` of the pixels plus ``n_blobs`` soft elliptical blobs, tails
    under 0.02 cut to zero (the recipe of the program's synthetic starfield,
    drawn for a whole stack at once)."""
    dev, f64 = gen.device, torch.float64
    lit = torch.rand(count, h, w, generator=gen, device=dev, dtype=f64) < density
    intensity = 0.2 + 0.8 * torch.rand(count, h, w, generator=gen, device=dev, dtype=f64)
    img = torch.where(lit, intensity, torch.zeros_like(intensity))
    p = torch.rand(count, n_blobs, 5, generator=gen, device=dev, dtype=f64)
    cy, cx = p[..., 0] * h, p[..., 1] * w
    sy, sx = 1.5 + p[..., 2] * (h / 40.0), 1.5 + p[..., 3] * (w / 40.0)
    amp = 0.3 + 0.7 * p[..., 4]
    yy = torch.arange(h, device=dev, dtype=f64)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=f64)[None, None, :]
    for j in range(n_blobs):
        e = ((yy - cy[:, j, None, None]) / sy[:, j, None, None]) ** 2 \
            + ((xx - cx[:, j, None, None]) / sx[:, j, None, None]) ** 2
        img = img + amp[:, j, None, None] * torch.exp(-e)
    img = img.clamp(0.0, 1.0)
    return torch.where(img < 0.02, torch.zeros_like(img), img)


def measure(col: torch.Tensor, omega: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = (C x)[omega] in float64 from the float32 column, rounded to float32."""
    n = col.shape[-1]
    cx = torch.fft.irfft(torch.fft.rfft(col.double()) * torch.fft.rfft(x.double(), n=n), n=n)
    return cx[..., omega].float().contiguous()


def contract_mix(gen: np.random.Generator, count: int, mix: list) -> np.ndarray:
    """Per-item tolerances: ``mix`` is [[tol, weight], ...]; the counts are
    the weights' shares of ``count`` exactly (the largest remainders take
    the rest), in an order drawn from ``gen``."""
    weights = np.array([w for _, w in mix], dtype=float)
    share = weights / weights.sum() * count
    counts = np.floor(share).astype(int)
    rest = count - counts.sum()
    counts[np.argsort(-(share - counts), kind="stable")[:rest]] += 1
    tols = np.concatenate([np.full(c, t, dtype=float) for (t, _), c in zip(mix, counts)])
    return tols[gen.permutation(count)]


def arrival_times(gen: np.random.Generator, count: int, seconds: float) -> np.ndarray:
    """``count`` sorted arrival times in [0, seconds): a Poisson process
    conditioned on its count (sorted uniform draws), so every seed offers
    the same load."""
    return np.sort(gen.uniform(0.0, 1.0, size=count)) * seconds
