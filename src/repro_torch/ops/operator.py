"""The operator contract the solver drivers are generic over.

Port of ``repro/ops/operator.py``.  Everything in the paper's solver family
touches a sensing operator through four capabilities, and nothing else:

    matvec(x)                A @ x        (Alg. 1 line 3, Alg. 3 line 4)
    rmatvec(y)               A^T @ y      (Alg. 1 line 4, Alg. 3 line 3)
    operator_norm_bound()    an upper bound on ||A||_2, for the safe ISTA
                             step size tau < 1/||A||^2 (Alg. 1 init)
    n                        signal length

All of them act on the trailing axis and broadcast over leading batch
axes.  :mod:`repro_torch.core.circulant` provides the three concrete
families (``DenseOperator``, the PISTA/PADMM baseline; ``Circulant``;
``PartialCirculant``), and :func:`repro_torch.ops.plan.plan` lowers any
conforming operator to one device, or a (partial) circulant to a mesh.

``gram_inverse_spectrum`` is the extra structure CPADMM needs (Alg. 3 line
2): operators built on a circulant invert ``rho A^T A + sigma I`` as a
pointwise spectral reciprocal.  It is a protocol of its own because a dense
operator pays O(n^3) for the same inverse
(:func:`repro_torch.core.admm.dense_admm_setup`).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class RecoveryOperator(Protocol):
    """Minimal operator surface consumed by every solver driver."""

    @property
    def n(self) -> int:  # signal length (trailing-axis extent of x)
        ...

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x, broadcasting over leading batch axes."""
        ...

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A^T @ y, broadcasting over leading batch axes."""
        ...

    def operator_norm_bound(self) -> torch.Tensor:
        """A guaranteed *upper* bound on ||A||_2 (safe ISTA step sizes)."""
        ...


@runtime_checkable
class GramInvertibleOperator(RecoveryOperator, Protocol):
    """Operators whose regularized gram matrix inverts in the spectrum:
    ``gram_inverse_spectrum(rho, sigma)`` returns the half spectrum of
    ``(rho C^T C + sigma I)^{-1}``, C the operator's circulant part."""

    def gram_inverse_spectrum(self, rho, sigma) -> torch.Tensor:
        ...
