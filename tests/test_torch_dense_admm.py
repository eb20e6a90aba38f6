"""Dense ADMM (paper Alg. 2, the PADMM baseline) against the reference.

The reference builds each problem (a normalised partial Gaussian circulant,
densified) and hands it to the port as numpy arrays.  Tolerances:

* the setup's inverse ``(A^T A + rho I)^{-1}``: both packages invert in
  float32 by LU (LAPACK on the CPU), whose backward error bound gives a
  norm-relative error of at most cond(A^T A + rho I) * n * 2^-24 (about
  1e-3 here, cond <= (1 + rho) / rho ~ 101 for a unit-norm A); this is the
  one place the two inverses' rounding is held, and the step tests below
  take the reference's inverse;
* one step from the same state: 1e-5 norm-relative, the reference's fp32
  contract, x and z against their own norms and u against x's (u is the
  difference of x and z, two O(1) values, so its rounding is on x's scale);
* free-running trajectories: each step's product with B (norm up to 1/rho =
  100) amplifies the last step's rounding, so 20 steps drift to ~6e-5 and are
  held at 1e-4, as ``test_torch_solvers.py`` holds whole solves;
* the CPADMM / dense ADMM fixed point: the reference test's own limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RecoveryProblem as RefProblem
from repro.core import densify as ref_densify
from repro.core import solve_until as ref_solve_until
from repro.core.admm import DenseAdmmState as RefState
from repro.core.admm import default_cpadmm_params as ref_default_params
from repro.core.admm import dense_admm_init as ref_init
from repro.core.admm import dense_admm_setup as ref_setup
from repro.core.admm import dense_admm_step as ref_step
from repro.core.circulant import partial_gaussian_circulant as ref_pgc
from repro.data.synthetic import paper_regime as ref_regime
from repro.data.synthetic import sparse_signal as ref_sparse
from repro_torch import interop
from repro_torch.core import DenseOperator, admm, densify
from repro_torch.core.ista import lasso_objective
from repro_torch.core.kernel_backend import dense_admm_step_kernel
from repro_torch.core.solvers import (
    RecoveryProblem,
    make_stepper,
    solve,
    solve_checkpointed,
    solve_until,
)
from repro_torch.kernels.soft_threshold.ops import fused_admm_update
from repro_torch.ops.plan import plan

ALPHA, RHO = 1e-4, 0.01  # benchmarks/bench_admm_recovery.py's dense parameters


def rel(got, want, scale=None):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want if scale is None else scale)
                                               + 1e-30))


def t(a):
    return torch.from_numpy(np.array(a))


def _problems(n, batch=(), seed=0):
    """The same dense sensing problem on both sides: (reference, port)."""
    m, k = ref_regime(n)
    x = ref_sparse(jax.random.PRNGKey(seed), n, k, batch=batch)
    op = ref_densify(ref_pgc(jax.random.PRNGKey(seed + 1), n, m, normalize=True))
    y = op.matvec(x)
    port_op = interop.dense_operator_from_numpy(np.asarray(op.mat), device="cpu")
    return RefProblem(op=op, y=y, x_true=x), RecoveryProblem(port_op, t(y), t(x))


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("n", [64, 256])
def test_dense_admm_setup_matches_reference(n, batch):
    ref, port = _problems(n, batch, seed=n)
    c_ref = ref_setup(ref.op, ref.y, RHO)
    c = admm.dense_admm_setup(port.op, port.y, RHO)
    a = np.asarray(ref.op.mat, np.float64)
    cond = np.linalg.cond(a.T @ a + RHO * np.eye(n))
    assert cond <= (1 + RHO) / RHO
    assert rel(c.B, c_ref.B) <= cond * n * 2.0**-24
    assert rel(c.Aty, c_ref.Aty) <= 1e-5
    assert c.B.shape == (n, n) and c.Aty.shape == batch + (n,)


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("n", [64, 256])
def test_dense_admm_steps_match_reference(n, batch):
    """20 steps: each port step from the reference's state (1e-5), and a
    free-running port trajectory (1e-4), both on the reference's inverse."""
    ref, port = _problems(n, batch, seed=n + 1)
    c_ref = ref_setup(ref.op, ref.y, RHO)
    c = admm.DenseAdmmConst(B=t(c_ref.B), Aty=port.op.rmatvec(port.y))
    s_ref, s = ref_init(ref.op, ref.y), admm.dense_admm_init(port.op, port.y)
    for it in range(20):
        one = admm.dense_admm_step(c, admm.DenseAdmmState(*(t(a) for a in s_ref)), ALPHA, RHO)
        s_ref = ref_step(c_ref, s_ref, ALPHA, RHO)
        s = admm.dense_admm_step(c, s, ALPHA, RHO)
        assert rel(one.x, s_ref.x) <= 1e-5, it
        assert rel(one.z, s_ref.z) <= 1e-5, it
        assert rel(one.u, s_ref.u, scale=s_ref.x) <= 1e-5, it
    for f in ("x", "z"):
        assert rel(getattr(s, f), getattr(s_ref, f)) <= 1e-4, f
    assert rel(s.u, s_ref.u, scale=s_ref.x) <= 1e-4


def test_dense_admm_step_with_a_prox_matches_reference():
    """``prox=`` swaps the z-update, as the reference's step does."""
    from repro.ops.prox import L1Prox as RefL1
    from repro_torch.ops.prox import L1Prox

    ref, port = _problems(128, (2,), seed=3)
    c_ref = ref_setup(ref.op, ref.y, RHO)
    c = admm.DenseAdmmConst(B=t(c_ref.B), Aty=port.op.rmatvec(port.y))
    s_ref = ref_step(c_ref, ref_init(ref.op, ref.y), ALPHA, RHO, prox=RefL1())
    s = admm.dense_admm_step(c, admm.dense_admm_init(port.op, port.y), ALPHA, RHO,
                             prox=L1Prox())
    assert rel(s.z, s_ref.z) <= 1e-5 and rel(s.x, s_ref.x) <= 1e-5


def test_default_cpadmm_params_match_reference():
    for kw in ({}, dict(alpha=1e-3, rho=0.01, sigma=0.02, tau=1.5)):
        got, want = admm.default_cpadmm_params(**kw), ref_default_params(**kw)
        assert got._fields == want._fields
        np.testing.assert_allclose(np.array(got, np.float32), np.array(want), rtol=0)


def test_cpadmm_matches_dense_admm_fixed_point():
    """Mirror of tests/test_solvers.py's: CPADMM (Alg. 3) and dense ADMM
    (Alg. 2) reach the same LASSO minimiser, with its limits."""
    m, k = ref_regime(96)
    x = ref_sparse(jax.random.PRNGKey(4), 96, k)
    op = ref_pgc(jax.random.PRNGKey(5), 96, m, normalize=True)
    circ = interop.partial_circulant_from_numpy(np.asarray(op.circ.col),
                                                np.asarray(op.circ.spec),
                                                np.asarray(op.omega), device="cpu")
    prob = RecoveryProblem(circ, t(op.matvec(x)), t(x))
    dense = RecoveryProblem(densify(circ), prob.y, prob.x_true)
    xc, _ = solve(prob, "cpadmm", iters=2500, record_every=2500, alpha=ALPHA, rho=RHO,
                  sigma=RHO)
    xd, _ = solve(dense, "admm", iters=2500, record_every=2500, alpha=ALPHA, rho=RHO)
    np.testing.assert_allclose(xc.numpy(), xd.numpy(), atol=2e-3)
    oc = float(lasso_objective(circ, prob.y, xc, ALPHA))
    od = float(lasso_objective(circ, prob.y, xd, ALPHA))
    assert oc == pytest.approx(od, rel=1e-2)


@pytest.mark.parametrize("method", ["admm", "padmm"])
def test_dense_admm_needs_a_dense_operator(method):
    m, k = ref_regime(64)
    op = ref_pgc(jax.random.PRNGKey(0), 64, m, normalize=True)
    circ = interop.partial_circulant_from_numpy(np.asarray(op.circ.col),
                                                np.asarray(op.circ.spec),
                                                np.asarray(op.omega), device="cpu")
    prob = RecoveryProblem(circ, circ.matvec(torch.ones(64)))
    with pytest.raises(TypeError, match="dense ADMM needs a DenseOperator; use 'cpadmm'"):
        make_stepper(prob, method)
    dense = RecoveryProblem(densify(circ), prob.y)
    with pytest.raises(TypeError, match="cpadmm needs a PartialCirculant"):
        make_stepper(dense, "cpadmm")


@pytest.mark.parametrize("method", ["admm", "padmm"])
def test_solve_dense_admm_matches_reference(method):
    ref, port = _problems(128, (3,), seed=6)
    from repro.core import solve as ref_solve

    x_ref, tr_ref = ref_solve(ref, method, iters=200, record_every=50, alpha=ALPHA, rho=RHO)
    x, tr = solve(port, method, iters=200, record_every=50, alpha=ALPHA, rho=RHO)
    assert rel(x, x_ref) <= 1e-4
    assert rel(tr.objective, tr_ref.objective) <= 1e-4
    assert tr.mse.shape == (4, 3)


def test_solve_until_dense_admm_matches_reference():
    """The per-signal freeze drives dense ADMM as it drives the others."""
    ref, port = _problems(128, (3,), seed=8)
    until = dict(tol=1e-4, max_iters=400, min_iters=20, alpha=ALPHA, rho=RHO)
    x_ref, it_ref = ref_solve_until(ref, "admm", **until)
    x, its = solve_until(port, "admm", **until)
    np.testing.assert_array_equal(its.numpy(), np.asarray(it_ref))
    assert rel(x, x_ref) <= 1e-4
    assert int(its.max()) < 400  # converged: the loop ended on tol


def test_solve_checkpointed_dense_admm_resumes_exactly():
    _, port = _problems(128, (2,), seed=10)
    kw = dict(alpha=ALPHA, rho=RHO)
    saved = {}
    x_full, mse = solve_checkpointed(port, "admm", iters=60, chunk=20,
                                     save_cb=lambda step, s: saved.__setitem__(step, s), **kw)
    x_resumed, _ = solve_checkpointed(port, "admm", iters=60, chunk=20,
                                      restore=(40, saved[40]), **kw)
    assert torch.equal(x_full, x_resumed) and mse.shape == (2,)
    assert isinstance(saved[20], admm.DenseAdmmState)


def test_dense_kernel_step_matches_plain_step():
    """The kernel step's z- and u-updates in one fused call (its plain
    version on the CPU) against the plain step: u' = u + (x - z) against
    (u + x) - z, a rounding of x's scale apart each step, which the next
    product with B (norm up to 1/rho = 100) amplifies; 10 steps drift to
    ~4e-6 of x's scale, held at 1e-5."""
    _, port = _problems(256, (3,), seed=11)
    c = admm.dense_admm_setup(port.op, port.y, RHO)
    s_plain = s_kernel = admm.dense_admm_init(port.op, port.y)
    fused_admm_update.launches = 0
    for _ in range(10):
        s_plain = admm.dense_admm_step(c, s_plain, ALPHA, RHO)
        s_kernel = dense_admm_step_kernel(c, s_kernel, ALPHA, RHO)
    for f in ("x", "z", "u"):
        assert rel(getattr(s_kernel, f), getattr(s_plain, f).numpy(),
                   scale=s_plain.x.numpy()) <= 1e-5, f
    assert fused_admm_update.launches == 0  # CPU tensors: the plain version


class _NonNegShrink:
    tag = "nonneg-test"

    def apply(self, x, gamma):
        return torch.clamp(x - gamma, min=0.0)


@pytest.mark.parametrize("tail,prox,kernel_steps", [
    ("kernel", None, True),
    ("plain", None, False),
    (None, None, False),  # a DenseOperator resolves to the plain step, on any device
    ("kernel", _NonNegShrink(), False),
])
def test_make_stepper_routes_dense_admm(tail, prox, kernel_steps, monkeypatch):
    from repro_torch.core import solvers

    calls = []
    kernel_step = solvers.dense_admm_step_kernel
    monkeypatch.setattr(solvers, "dense_admm_step_kernel",
                        lambda *a: calls.append(1) or kernel_step(*a))
    _, port = _problems(128, (2,), seed=12)
    pl = plan(port.op, tail=tail, prox=prox)
    assert pl.tail == (tail or "plain") and pl.operator is port.op
    x, _ = solve(port, "admm", iters=10, alpha=ALPHA, rho=RHO, plan=pl)
    x_plain, _ = solve(port, "admm", iters=10, alpha=ALPHA, rho=RHO, prox=prox)
    assert len(calls) == (10 if kernel_steps else 0)
    assert rel(x, x_plain.numpy()) <= 1e-5  # the kernel step's u-update rounds apart


def test_dense_ista_has_no_kernel_step():
    """PISTA on a DenseOperator runs the plain step; asking for the kernel
    tail raises, as for any operator but a PartialCirculant."""
    _, port = _problems(64, (), seed=13)
    x, _ = solve(port, "ista", iters=5)
    assert x.shape == (64,)
    with pytest.raises(TypeError, match="PartialCirculant"):
        solve(port, "ista", iters=1, plan=plan(port.op, tail="kernel"))


def test_interop_carries_the_dense_operator():
    ref, port = _problems(64, (), seed=14)
    assert isinstance(port.op, DenseOperator) and port.op.shape == (32, 64)
    assert np.array_equal(port.op.mat.numpy(), np.asarray(ref.op.mat))
    state = RefState(*(jnp.zeros(64) for _ in range(3)))
    assert admm.DenseAdmmState(*(t(a) for a in state)).x.shape == (64,)
