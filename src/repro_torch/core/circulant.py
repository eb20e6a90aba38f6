"""Circulant / partial-circulant sensing operators (paper Secs. 4.2-4.3, 7).

Port of ``repro/core/circulant.py``.  The same conventions hold: the paper
describes a circulant by its *first row* ``v`` (``A[i, j] = v[(j - i) mod
n]``); the operator stores the *first column* ``col`` and its half
spectrum ``spec = rfft(col)``, since ``C = F^H diag(fft(col)) F`` makes every
product, transpose, inverse and composition pointwise in the spectrum.

All operators act on the trailing axis and broadcast over leading batch
axes.  Every factory takes ``device=`` (``None`` = the CUDA default, see
:mod:`repro_torch.device`); random factories take a ``torch.Generator``
and draw on the generator's device, so one seed gives one operator
wherever the result is then placed.  ``DenseOperator`` is the explicit
matrix of the PISTA / PADMM baselines, and ``densify`` makes one of any
operator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..device import resolve_device
from ..ops.spectral import gram_inverse_spectrum as _gram_inverse_spectrum
from ..ops.spectral import irfft as _irfft
from ..ops.spectral import rfft as _rfft


@dataclasses.dataclass(frozen=True)
class Circulant:
    """Square circulant operator, stored as first column + cached spectrum."""

    col: torch.Tensor  # (n,) real, first column
    spec: torch.Tensor  # (n//2 + 1,) complex, rfft(col) == eigenvalues (half-plane)

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_first_col(cls, col: torch.Tensor) -> "Circulant":
        return cls(col=col, spec=_rfft(col, col.shape[-1]))

    @classmethod
    def from_first_row(cls, row: torch.Tensor) -> "Circulant":
        """Paper convention: ``A[i, j] = row[(j - i) mod n]``."""
        return cls.from_first_col(_row_to_col(row))

    @classmethod
    def from_spectrum(cls, spec: torch.Tensor, n: int) -> "Circulant":
        col = _irfft(spec, n)
        return cls(col=col, spec=_rfft(col, n))  # re-fft keeps exact pairing

    # -- basic facts -------------------------------------------------------
    @property
    def n(self) -> int:
        return self.col.shape[-1]

    @property
    def first_row(self) -> torch.Tensor:
        return _row_to_col(self.col)  # the same flip-and-roll is an involution

    def operator_norm(self) -> torch.Tensor:
        """Exact spectral norm: max |eigenvalue| = max |fft(col)|."""
        return self.spec.abs().max()

    def operator_norm_bound(self) -> torch.Tensor:
        """The RecoveryOperator-protocol bound — exact for circulants."""
        return self.operator_norm()

    # -- algebra (all O(n) / O(n log n)) ----------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """C @ x via the convolution theorem."""
        return _irfft(self.spec * _rfft(x, self.n), self.n)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """C.T @ x.  For real circulants, spec(C.T) = conj(spec(C))."""
        return _irfft(self.spec.conj() * _rfft(x, self.n), self.n)

    def gram(self) -> "Circulant":
        """C.T @ C — circulant with spectrum |spec|^2 (real, >= 0)."""
        return Circulant.from_spectrum((self.spec.abs() ** 2).to(self.spec.dtype), self.n)

    def compose(self, other: "Circulant") -> "Circulant":
        """self @ other — circulants commute and multiply spectra.

        The composed operator stores the *exact* pointwise product spectrum
        (what every matvec and gram inverse consumes), with its first column
        derived from it once — no irfft -> rfft round trip.
        """
        if self.n != other.n:
            raise ValueError(
                f"cannot compose circulants of different sizes: "
                f"n={self.n} vs n={other.n}"
            )
        spec = self.spec * other.spec
        return Circulant(col=_irfft(spec, self.n), spec=spec)

    def add_scaled_identity(self, rho: float, sigma: float) -> "Circulant":
        """rho * C + sigma * I."""
        return Circulant.from_spectrum(rho * self.spec + sigma, self.n)

    def inverse(self) -> "Circulant":
        """C^{-1} via reciprocal spectrum (paper Alg. 3 line 2)."""
        return Circulant.from_spectrum(1.0 / self.spec, self.n)

    def gram_inverse_spectrum(self, rho, sigma) -> torch.Tensor:
        """Half spectrum of (rho C^T C + sigma I)^{-1} — the CPADMM inner
        inverse (Alg. 3 line 2), pointwise in the spectrum."""
        return _gram_inverse_spectrum(self.spec, rho, sigma)

    def transpose(self) -> "Circulant":
        return Circulant.from_spectrum(self.spec.conj(), self.n)

    # -- oracle (O(n^2); tests / small-n baselines only) ------------------
    def to_dense(self) -> torch.Tensor:
        return self.dense_rows()

    def dense_rows(self, rows=None) -> torch.Tensor:
        """Rows ``rows`` (all by default) of the dense matrix, C[i, j] =
        col[(i - j) mod n]: row i is the window ``rev[n-1-i : 2n-1-i]`` of
        ``rev``, the doubled column reversed, so the rows are gathered from
        a strided view with no (n, n) index array."""
        n = self.n
        rev = torch.cat([self.col, self.col]).flip(0)
        windows = rev.unfold(0, n, 1)  # windows[s] = rev[s : s + n]
        i = torch.arange(n, device=self.col.device) if rows is None else rows
        return windows[n - 1 - i]


def _row_to_col(row: torch.Tensor) -> torch.Tensor:
    """col[i] = row[(-i) mod n] (and back: the map is its own inverse)."""
    return torch.roll(torch.flip(row, dims=(-1,)), 1, dims=-1)


@dataclasses.dataclass(frozen=True)
class PartialCirculant:
    """A = P @ C: random row subsampling of a square circulant (Sec. 4.3).

    ``P`` is the m-by-n row selector for the index set ``omega`` (sorted,
    int64).  The sensing operator of CPADMM, and the deblurring operator
    when ``C = C_sense @ B_blur`` (Sec. 7).
    """

    circ: Circulant
    omega: torch.Tensor  # (m,) int64 sorted row indices

    @property
    def n(self) -> int:
        return self.circ.n

    @property
    def m(self) -> int:
        return self.omega.shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x = (C @ x)[omega]."""
        return self.circ.matvec(x)[..., self.omega]

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A.T @ y = C.T @ (P.T @ y) — scatter then circulant transpose."""
        return self.circ.rmatvec(self.project_back(y))

    def project_back(self, y: torch.Tensor) -> torch.Tensor:
        """P.T @ y: scatter m measurements into an n-vector."""
        out = y.new_zeros(y.shape[:-1] + (self.n,))
        out[..., self.omega] = y
        return out

    def operator_norm_bound(self) -> torch.Tensor:
        """||P C||_2 <= ||C||_2 (P is a selector with norm 1) — the safe
        ISTA step size tau < 1/||A||^2 (paper Alg. 1)."""
        return self.circ.operator_norm()

    def gram_inverse_spectrum(self, rho, sigma) -> torch.Tensor:
        """Spectrum of (rho C^T C + sigma I)^{-1} for the circulant part (the
        P part is CPADMM's diagonal D; see repro_torch.core.admm)."""
        return self.circ.gram_inverse_spectrum(rho, sigma)

    def to_dense(self) -> torch.Tensor:
        return self.circ.dense_rows(self.omega)


@dataclasses.dataclass(frozen=True)
class DenseOperator:
    """Explicitly materialized m-by-n sensing matrix: the circulant-agnostic
    baseline (PISTA / PADMM).  Memory O(mn); matvec O(mn)."""

    mat: torch.Tensor  # (m, n)

    @property
    def m(self) -> int:
        return self.mat.shape[-2]

    @property
    def n(self) -> int:
        return self.mat.shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x over leading batch axes."""
        return torch.matmul(x, self.mat.mT)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A.T @ y over leading batch axes."""
        return torch.matmul(y, self.mat)

    def operator_norm_bound(self) -> torch.Tensor:
        """A *guaranteed upper* bound on ||A||_2 (power iteration only gives a
        lower bound, which would make tau unsafe): min of the Holder bound
        sqrt(||A||_1 ||A||_inf) and the Frobenius norm."""
        a = self.mat.abs()
        holder = torch.sqrt(a.sum(dim=0).max() * a.sum(dim=1).max())
        return torch.minimum(holder, torch.linalg.vector_norm(self.mat))

    def to_dense(self) -> torch.Tensor:
        return self.mat


def densify(op) -> DenseOperator:
    """Materialize any structured operator (for baselines / oracles)."""
    return DenseOperator(op.to_dense())


# ---------------------------------------------------------------------------
# Sensing-operator factories (paper Sec. 6 experimental setup)
# ---------------------------------------------------------------------------


def gaussian_circulant(
    gen: torch.Generator, n: int, dtype=torch.float32, normalize: bool = False,
    device=None,
) -> Circulant:
    """Paper-faithful: first row drawn i.i.d. standard Gaussian (Sec. 6).

    ``normalize=True`` rescales to unit spectral norm (exact for
    circulants), which conditions ISTA's step size to tau ~= 1.
    """
    device = resolve_device(device)
    row = torch.randn(n, generator=gen, dtype=dtype, device=gen.device).to(device)
    c = Circulant.from_first_row(row)
    if normalize:
        c = Circulant.from_first_col(c.col / c.operator_norm())
    return c


def romberg_circulant(
    gen: torch.Generator, n: int, dtype=torch.float32, device=None
) -> Circulant:
    """Beyond-paper random-convolution sensing (Romberg 2009, the paper's
    ref [22]): unit-magnitude spectrum with random phase, so C is orthogonal
    (C^T C = I) and ISTA's safe step is tau = 1."""
    device = resolve_device(device)
    nfreq = n // 2 + 1
    phase = torch.rand(nfreq, generator=gen, dtype=dtype, device=gen.device).to(device)
    spec = torch.polar(torch.ones_like(phase), phase * (2 * math.pi))
    # DC and (for even n) Nyquist bins must be real for a real time-domain row.
    spec[0] = 1.0
    if n % 2 == 0:
        spec[-1] = 1.0
    return Circulant.from_first_col(_irfft(spec, n).to(dtype))


def random_omega(gen: torch.Generator, n: int, m: int, device=None) -> torch.Tensor:
    """Random sorted m-subset of {0..n-1} (the support of P), int64."""
    device = resolve_device(device)
    perm = torch.randperm(n, generator=gen, device=gen.device)[:m]
    return torch.sort(perm).values.to(device)


def partial_gaussian_circulant(
    gen: torch.Generator, n: int, m: int, dtype=torch.float32,
    normalize: bool = False, device=None,
) -> PartialCirculant:
    return PartialCirculant(
        gaussian_circulant(gen, n, dtype, normalize=normalize, device=device),
        random_omega(gen, n, m, device=device),
    )


def partial_romberg_circulant(
    gen: torch.Generator, n: int, m: int, dtype=torch.float32, device=None
) -> PartialCirculant:
    return PartialCirculant(
        romberg_circulant(gen, n, dtype, device=device),
        random_omega(gen, n, m, device=device),
    )


# ---------------------------------------------------------------------------
# Blur composition (paper Sec. 7)
# ---------------------------------------------------------------------------


def moving_average_blur(n: int, order: int, dtype=torch.float32, device=None) -> Circulant:
    """Order-L blur: first row = [1/L]*L then zeros, right-circulated (Sec. 7).
    ``order`` must lie in (0, n], or the filter would wrap and no longer sum
    to 1."""
    if not 0 < order <= n:
        raise ValueError(
            f"blur order must satisfy 0 < order <= n; got order={order}, n={n} "
            f"(an order > n filter would wrap past the signal and truncate)"
        )
    row = torch.zeros(n, dtype=dtype, device=resolve_device(device))
    row[:order] = 1.0 / order
    return Circulant.from_first_row(row)


def _circular_distance(n: int, dtype, device) -> torch.Tensor:
    j = torch.arange(n, dtype=dtype, device=resolve_device(device))
    return torch.minimum(j, n - j)


def gaussian_blur(n: int, sigma: float, dtype=torch.float32, device=None) -> Circulant:
    """Gaussian PSF periodized on the circle, normalized to sum 1;
    ``sigma`` must lie in (0, n]."""
    if not 0 < sigma <= n:
        raise ValueError(
            f"gaussian blur width must satisfy 0 < sigma <= n; got sigma={sigma}, "
            f"n={n} (sigma > n wraps the kernel into a flat average)"
        )
    d = _circular_distance(n, dtype, device)
    row = torch.exp(-0.5 * (d / sigma) ** 2)
    return Circulant.from_first_row(row / row.sum())


def _bessel_j1(x: torch.Tensor, nodes: int = 128) -> torch.Tensor:
    """J1 by fixed midpoint quadrature of (1/pi) int_0^pi cos(t - x sin t) dt
    (the reference's 128-node rule, kept so both packages agree)."""
    t = (torch.arange(nodes, dtype=x.dtype, device=x.device) + 0.5) * (math.pi / nodes)
    return torch.cos(t - x[..., None] * torch.sin(t)).mean(dim=-1)


def airy_blur(n: int, radius: float, dtype=torch.float32, device=None) -> Circulant:
    """Airy-disk PSF (2 J1(u)/u)^2 with ``radius`` the first dark ring
    (u = 3.8317 d / radius), periodized, truncated past four rings,
    normalized to sum 1; ``radius`` must lie in (0, n]."""
    if not 0 < radius <= n:
        raise ValueError(
            f"airy blur radius must satisfy 0 < radius <= n; got radius={radius}, "
            f"n={n} (the first dark ring cannot sit outside the signal)"
        )
    first_zero = 3.8317  # first root of J1
    d = _circular_distance(n, dtype, device)
    u = first_zero * d / radius
    safe_u = torch.where(u > 0, u, torch.ones_like(u))
    intensity = torch.where(
        u > 0, (2.0 * _bessel_j1(safe_u) / safe_u) ** 2, torch.ones_like(u)
    )
    intensity = torch.where(d <= 4.0 * radius, intensity, torch.zeros_like(u))
    return Circulant.from_first_row(intensity / intensity.sum())


def shift_circulant(n: int, shift: int, dtype=torch.float32, device=None) -> Circulant:
    """The raster-offset operator S_s with ``S_s x = roll(x, s)``: first
    column e_{s mod n}, unit-modulus spectrum.  Composing ``blur @ S_s``
    expresses one offset frame of a map-making scan
    (:mod:`repro_torch.core.mapmaking`) as a single circulant."""
    if n <= 0:
        raise ValueError(f"shift circulant needs n > 0; got n={n}")
    col = torch.zeros(n, dtype=dtype, device=resolve_device(device))
    col[int(shift) % n] = 1.0
    return Circulant.from_first_col(col)


def compose_sensing_blur(sense: Circulant, blur: Circulant) -> Circulant:
    """A = C @ B — still circulant (the key Sec. 7 observation)."""
    if sense.n != blur.n:
        raise ValueError(
            f"sensing and blur operators act on different signal lengths: "
            f"sense.n={sense.n} vs blur.n={blur.n}; build both for the same "
            f"flattened image size"
        )
    return sense.compose(blur)
