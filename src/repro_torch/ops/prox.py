"""Pluggable proximal operators: the prior as a plan knob.

Port of ``repro/ops/prox.py``.  A prox is a value with ``apply(x, gamma)``
computing

    prox_{gamma * R}(x) = argmin_z  0.5 * ||z - x||^2 + gamma * R(z)

that threads through ``PlanConfig(prox=)`` and the solver steppers.
Contract, as in the reference:

* ``apply(x, gamma)`` acts on the trailing axis (a flat signal of length n)
  and broadcasts over leading batch axes; ``gamma`` is a number or a
  0-dimensional tensor.
* ``tag`` is a stable human-readable id (``PlanConfig.describe()`` shows
  it); distinct hyper-parameters give distinct tags.
* ``elementwise`` marks proxes that act coordinate-wise.  On a mesh those
  run on a rank's row block as they are; TV and wavelet need the whole
  signal, so the mesh's step gathers it first
  (:mod:`repro_torch.ops.plan`).
* ``L1Prox.apply`` is the expression of
  :func:`repro_torch.core.soft_threshold.soft_threshold`, so
  ``prox=L1Prox()`` changes no number, and the kernel steps stay reachable
  exactly when ``is_l1(prox)``.
* TV and wavelet also expose the ``analysis_op`` / ``analysis_rmatvec``
  pair (D and D^T of the analysis form ``R(z) = ||D z||_1``).

The wavelet taps stay Python floats that multiply tensors: a small tensor
built from a list on every call would be a blocking host-to-card copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, ClassVar, Dict, Tuple

import torch


def _soft(x: torch.Tensor, gamma) -> torch.Tensor:
    # the expression of core.soft_threshold.soft_threshold, kept here so this
    # module imports nothing of the port (core's drivers import it)
    return torch.sign(x) * torch.clamp(x.abs() - gamma, min=0.0)


class Prox:
    """Base of the proximal operators (see the module docstring).

    Subclasses are frozen dataclasses with hashable fields only, so a prox
    can sit inside the frozen ``PlanConfig``.
    """

    kind: ClassVar[str]
    elementwise: ClassVar[bool]

    @property
    def tag(self) -> str:
        raise NotImplementedError

    def apply(self, x: torch.Tensor, gamma) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        d = {"kind": self.kind}
        d.update(
            {
                f.name: (list(v) if isinstance(v := getattr(self, f.name), tuple) else v)
                for f in dataclasses.fields(self)  # type: ignore[arg-type]
            }
        )
        return d


@dataclasses.dataclass(frozen=True)
class L1Prox(Prox):
    """Identity-basis l1 soft threshold (paper Eq. 4): the default prior."""

    kind: ClassVar[str] = "l1"
    elementwise: ClassVar[bool] = True

    @property
    def tag(self) -> str:
        return "l1"

    def apply(self, x: torch.Tensor, gamma) -> torch.Tensor:
        return _soft(x, gamma)


@dataclasses.dataclass(frozen=True)
class NonNegL1Prox(Prox):
    """l1 and non-negativity: the one-sided shrink max(x - gamma, 0).

    Astronomical frames are photon counts, so positivity is free
    regularisation (Bobin/Starck Sec. 5).  ``clamp_min`` keeps a NaN, as
    ``jnp.maximum`` does.
    """

    kind: ClassVar[str] = "nonneg-l1"
    elementwise: ClassVar[bool] = True

    @property
    def tag(self) -> str:
        return "nonneg-l1"

    def apply(self, x: torch.Tensor, gamma) -> torch.Tensor:
        return torch.clamp_min(x - gamma, 0.0)


@dataclasses.dataclass(frozen=True)
class TVProx(Prox):
    """Anisotropic 2-D total variation by Chambolle's dual projection.

    ``R(z) = ||Dv z||_1 + ||Dh z||_1`` with periodic forward differences
    (the circulant operators' wrap-around).  The dual

        min_{||p||_inf <= gamma}  0.5 * ||x - D^T p||^2

    is solved by ``iters`` projected-gradient steps of the safe step 1/8
    (||D||^2 <= 8), and the primal is ``z = x - D^T p``.  The operations run
    in the reference's order, so float32 stays within an ulp or two of it
    over the inner steps.
    """

    shape: Tuple[int, int]
    iters: int = 10
    kind: ClassVar[str] = "tv"
    elementwise: ClassVar[bool] = False

    def __post_init__(self):
        h, w = self.shape
        if not (h > 0 and w > 0):
            raise ValueError(f"TVProx shape must be positive; got {self.shape}")
        if self.iters <= 0:
            raise ValueError(f"TVProx iters must be positive; got {self.iters}")
        object.__setattr__(self, "shape", (int(h), int(w)))

    @property
    def tag(self) -> str:
        h, w = self.shape
        return f"tv[{h}x{w},it{self.iters}]"

    def _check(self, x: torch.Tensor) -> None:
        h, w = self.shape
        if x.shape[-1] != h * w:
            raise ValueError(
                f"TVProx expects trailing axis of length h*w = {h * w} "
                f"(shape={self.shape}); got {x.shape[-1]}"
            )

    def apply(self, x: torch.Tensor, gamma) -> torch.Tensor:
        self._check(x)
        h, w = self.shape
        img = x.reshape(x.shape[:-1] + (h, w))

        def dv(z):
            return torch.roll(z, -1, dims=-2) - z

        def dh(z):
            return torch.roll(z, -1, dims=-1) - z

        def dvt(p):
            return torch.roll(p, 1, dims=-2) - p

        def dht(p):
            return torch.roll(p, 1, dims=-1) - p

        p1 = p2 = torch.zeros_like(img)
        for _ in range(self.iters):
            z = img - (dvt(p1) + dht(p2))
            p1 = torch.clamp(p1 + 0.125 * dv(z), -gamma, gamma)
            p2 = torch.clamp(p2 + 0.125 * dh(z), -gamma, gamma)
        out = img - (dvt(p1) + dht(p2))
        return out.reshape(x.shape)

    def analysis_op(self, x: torch.Tensor) -> torch.Tensor:
        """D x: stacked periodic differences, (..., n) -> (..., 2n)."""
        self._check(x)
        h, w = self.shape
        img = x.reshape(x.shape[:-1] + (h, w))
        dv = torch.roll(img, -1, dims=-2) - img
        dh = torch.roll(img, -1, dims=-1) - img
        flat = x.shape[:-1] + (h * w,)
        return torch.cat([dv.reshape(flat), dh.reshape(flat)], dim=-1)

    def analysis_rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        """D^T c: adjoint of ``analysis_op``, (..., 2n) -> (..., n)."""
        h, w = self.shape
        n = h * w
        if c.shape[-1] != 2 * n:
            raise ValueError(
                f"TVProx analysis_rmatvec expects trailing axis 2n = {2 * n}; got {c.shape[-1]}"
            )
        grid = c.shape[:-1] + (h, w)
        p1 = c[..., :n].reshape(grid)
        p2 = c[..., n:].reshape(grid)
        out = (torch.roll(p1, 1, dims=-2) - p1) + (torch.roll(p2, 1, dims=-1) - p2)
        return out.reshape(c.shape[:-1] + (n,))


_SQRT2 = math.sqrt(2.0)
_SQRT3 = math.sqrt(3.0)
_WAVELET_FILTERS: Dict[str, Tuple[float, ...]] = {
    "haar": (1.0 / _SQRT2, 1.0 / _SQRT2),
    "db4": (
        (1.0 + _SQRT3) / (4.0 * _SQRT2),
        (3.0 + _SQRT3) / (4.0 * _SQRT2),
        (3.0 - _SQRT3) / (4.0 * _SQRT2),
        (1.0 - _SQRT3) / (4.0 * _SQRT2),
    ),
}


@dataclasses.dataclass(frozen=True)
class WaveletProx(Prox):
    """Soft threshold in an orthogonal periodized wavelet basis.

    ``prox_{gamma * ||W.||_1}(x) = W^T eta_gamma(W x)``, exact for an
    orthonormal W: a ``levels``-deep periodized DWT with Haar or
    Daubechies-4 filters.  Only the detail bands are thresholded; the
    coarsest approximation (the image's large-scale flux) is kept.
    """

    levels: int = 2
    wavelet: str = "haar"
    kind: ClassVar[str] = "wavelet"
    elementwise: ClassVar[bool] = False

    def __post_init__(self):
        if self.levels <= 0:
            raise ValueError(f"WaveletProx levels must be positive; got {self.levels}")
        if self.wavelet not in _WAVELET_FILTERS:
            raise ValueError(
                f"unknown wavelet {self.wavelet!r}; available: {sorted(_WAVELET_FILTERS)}"
            )

    @property
    def tag(self) -> str:
        return f"wavelet[{self.wavelet},L{self.levels}]"

    def _filters(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        # Python floats: a tensor op rounds a number to the tensor's dtype,
        # as the reference's filter arrays hold the taps
        h = _WAVELET_FILTERS[self.wavelet]
        # QMF pair: g[k] = (-1)^k h[L-1-k] (a sign flip is exact)
        g = tuple((-1.0) ** k * t for k, t in enumerate(reversed(h)))
        return h, g

    def _check(self, n: int) -> None:
        step = 2**self.levels
        flen = len(_WAVELET_FILTERS[self.wavelet])
        if n % step != 0 or n // step < flen:
            raise ValueError(
                f"WaveletProx(levels={self.levels}, wavelet={self.wavelet!r}) needs the "
                f"signal length divisible by 2^levels = {step} with at least {flen} "
                f"coefficients at the coarsest level; got n={n}"
            )

    @staticmethod
    def _down(a: torch.Tensor, f) -> torch.Tensor:
        # a'[i] = sum_m f[m] a[(2i+m) mod N]
        acc = f[0] * a
        for m in range(1, len(f)):
            acc = acc + f[m] * torch.roll(a, -m, dims=-1)
        return acc[..., ::2]

    @staticmethod
    def _up(c: torch.Tensor, f, n: int) -> torch.Tensor:
        # adjoint of _down: scatter to the even slots of a fresh array, then
        # correlate with +m rolls
        up = c.new_zeros(c.shape[:-1] + (n,))
        up[..., ::2] = c
        acc = f[0] * up
        for m in range(1, len(f)):
            acc = acc + f[m] * torch.roll(up, m, dims=-1)
        return acc

    def _decompose(self, x: torch.Tensor):
        h, g = self._filters()
        a = x
        details = []
        for _ in range(self.levels):
            details.append(self._down(a, g))
            a = self._down(a, h)
        return a, details, (h, g)

    def _reconstruct(self, a: torch.Tensor, details, filters) -> torch.Tensor:
        h, g = filters
        for d in reversed(details):
            a = self._up(a, h, 2 * a.shape[-1]) + self._up(d, g, 2 * a.shape[-1])
        return a

    def apply(self, x: torch.Tensor, gamma) -> torch.Tensor:
        self._check(x.shape[-1])
        a, details, filters = self._decompose(x)
        details = [_soft(d, gamma) for d in details]
        return self._reconstruct(a, details, filters)

    def analysis_op(self, x: torch.Tensor) -> torch.Tensor:
        """W x: concatenated [d_1 | d_2 | ... | d_L | a_L], same length as x."""
        self._check(x.shape[-1])
        a, details, _ = self._decompose(x)
        return torch.cat(details + [a], dim=-1)

    def analysis_rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        """W^T c: for an orthonormal W also the inverse transform."""
        n = c.shape[-1]
        self._check(n)
        lengths = [n // 2 ** (lvl + 1) for lvl in range(self.levels)]
        details, off = [], 0
        for ln in lengths:
            details.append(c[..., off:off + ln])
            off += ln
        return self._reconstruct(c[..., off:], details, self._filters())


PROX_KINDS: Dict[str, type] = {
    L1Prox.kind: L1Prox,
    NonNegL1Prox.kind: NonNegL1Prox,
    TVProx.kind: TVProx,
    WaveletProx.kind: WaveletProx,
}


def is_l1(prox) -> bool:
    """True when the prior is the identity-basis soft threshold: the prox
    the fused kernel tails compute, so they stay eligible."""
    return prox is None or type(prox) is L1Prox


def is_elementwise(prox) -> bool:
    """True when the prox acts coordinate-wise (on a rank's block as it is)."""
    return prox is None or bool(getattr(prox, "elementwise", False))


def prox_to_dict(prox) -> Dict[str, Any]:
    if prox is None:
        return None  # type: ignore[return-value]
    return prox.to_dict()


def prox_from_dict(d) -> Prox:
    """Rebuild a prox from its ``to_dict`` form (the PlanConfig round trip)."""
    if d is None:
        return None  # type: ignore[return-value]
    if isinstance(d, Prox):
        return d
    spec = dict(d)
    kind = spec.pop("kind", None)
    cls = PROX_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown prox kind {kind!r}; available: {sorted(PROX_KINDS)}")
    if "shape" in spec and isinstance(spec["shape"], list):
        spec["shape"] = tuple(spec["shape"])
    return cls(**spec)
