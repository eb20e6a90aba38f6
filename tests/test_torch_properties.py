"""The recovery invariants of ``tests/test_properties.py``, over the port.

The reference draws its cases with ``hypothesis``; here each property runs
on a fixed set of seeded cases (``parametrize``), the inputs drawn with
numpy or a CPU ``torch.Generator`` from the seed, with the reference
tests' own limits.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import RecoveryProblem, partial_gaussian_circulant, solve
from repro_torch.core.circulant import gaussian_circulant, romberg_circulant
from repro_torch.core.ista import lasso_objective
from repro_torch.core.soft_threshold import soft_threshold
from repro_torch.data.synthetic import paper_regime, sparse_signal


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _normal(seed, *shape, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


@pytest.mark.parametrize("seed,gamma,n", [(0, 0.0, 1), (1, 0.7, 57), (2, 3.0, 200),
                                          (3, 1.5, 128)])
def test_soft_threshold_is_nonexpansive_shrinkage(seed, gamma, n):
    x, y = _normal(seed, n, scale=3), _normal(seed + 1000, n, scale=3)
    sx, sy = soft_threshold(x, gamma), soft_threshold(y, gamma)
    # prox operators are firmly non-expansive
    assert float((sx - sy).norm()) <= float((x - y).norm()) + 1e-5
    # shrinkage: |sx| <= |x| elementwise, sign preserved or zeroed
    assert bool((sx.abs() <= x.abs() + 1e-6).all())
    assert bool(((sx == 0) | (torch.sign(sx) == torch.sign(x))).all())
    # exact kill zone
    assert bool((sx[x.abs() <= gamma] == 0).all())


@pytest.mark.parametrize("n,seed", [(4, 0), (37, 11), (128, 2024)])
def test_spectrum_homomorphism(n, seed):
    A = gaussian_circulant(_gen(seed), n, device="cpu")
    B = gaussian_circulant(_gen(seed + 1), n, device="cpu")
    scale = float(A.spec.abs().max() * B.spec.abs().max())
    # product of circulants -> product of spectra
    np.testing.assert_allclose(A.compose(B).spec.numpy(), (A.spec * B.spec).numpy(),
                               rtol=1e-3, atol=1e-2 * scale)
    # commutativity (circulants always commute)
    x = _normal(seed, n)
    np.testing.assert_allclose(
        A.matvec(B.matvec(x)).numpy(), B.matvec(A.matvec(x)).numpy(),
        atol=2e-2 * max(1.0, float(x.abs().max()))
        * float(A.operator_norm() * B.operator_norm()) / n,
    )


@pytest.mark.parametrize("n,seed", [(8, 0), (77, 5), (128, 31337)])
def test_parseval_for_romberg(n, seed):
    """Unit-spectrum sensing is an isometry: ||Cx|| == ||x||."""
    C = romberg_circulant(_gen(seed), n, device="cpu")
    x = _normal(seed, n)
    np.testing.assert_allclose(float(C.matvec(x).norm()), float(x.norm()), rtol=1e-4)


@pytest.mark.parametrize("n,seed", [(4, 0), (50, 9), (100, 4242)])
def test_adjoint_identity(n, seed):
    """<Cx, y> == <x, C^T y> — the identity ISTA's gradient step relies on."""
    C = gaussian_circulant(_gen(seed), n, device="cpu")
    x, y = _normal(seed, n), _normal(seed + 1, n)
    lhs = float(torch.dot(C.matvec(x), y))
    rhs = float(torch.dot(x, C.rmatvec(y)))
    assert abs(lhs - rhs) <= 1e-3 * (abs(lhs) + abs(rhs) + 1.0)


@pytest.mark.parametrize("seed", [0, 17, 4095])
def test_solver_beats_zero_solution(seed):
    n = 128
    m, k = paper_regime(n)
    g = _gen(seed)
    x = sparse_signal(g, n, k, device="cpu")
    op = partial_gaussian_circulant(g, n, m, normalize=True, device="cpu")
    prob = RecoveryProblem(op=op, y=op.matvec(x), x_true=x)
    xh, _ = solve(prob, "cpadmm", iters=150, record_every=150, alpha=1e-4, rho=0.01,
                  sigma=0.01)
    obj_zero = float(lasso_objective(op, prob.y, torch.zeros_like(xh), 1e-4))
    obj_hat = float(lasso_objective(op, prob.y, xh, 1e-4))
    assert obj_hat < obj_zero
