"""CPISTA on the kernel substrate against the reference.

``ista_step_kernel`` (matvec kernels + the fused soft-threshold kernel) is
held against the reference's ``ista_step_pallas`` (Pallas in interpret
mode) unbatched, and against its jnp ``ista_step`` batched, since the
reference's kernels take 1-D operands only (ROADMAP Queue 3).  On the CPU
the port's kernel step composes the kernels' plain versions.

Tolerances: 5e-5 absolute on 5-step state parity (the tolerance of
``tests/test_kernel_backend.py``); 1e-5 relative on x-hat for a whole
solve, the reference's fp32 contract (ISTA is a contraction, so rounding
does not compound as it does through FISTA's momentum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RecoveryProblem as RefProblem
from repro.core import solve as ref_solve
from repro.core.circulant import partial_gaussian_circulant as ref_pgc
from repro.core.ista import IstaParams as RefIstaParams
from repro.core.ista import ista_init as ref_ista_init
from repro.core.ista import ista_step as ref_ista_step
from repro.core.kernel_backend import ista_step_pallas
from repro.data.synthetic import paper_regime as ref_regime
from repro.data.synthetic import sparse_signal as ref_sparse
from repro_torch import interop
from repro_torch.core import ista
from repro_torch.core.kernel_backend import ista_step_kernel
from repro_torch.core.solvers import RecoveryProblem, solve
from repro_torch.kernels.circulant_matvec import ops as matvec_ops
from repro_torch.kernels.soft_threshold.ops import fused_ista_update
from repro_torch.kernels.soft_threshold.ref import ista_step_update_ref, ista_threshold_update_ref
from repro_torch.ops.plan import plan
from repro_torch.ops.prox import L1Prox


def rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _problems(n, batch=(), seed=0):
    """The same sensing problem on both sides: (reference, port)."""
    m, k = ref_regime(n)
    x = ref_sparse(jax.random.PRNGKey(seed), n, k, batch=batch)
    op = ref_pgc(jax.random.PRNGKey(seed + 1), n, m, normalize=True)
    y = op.matvec(x)
    port_op = interop.partial_circulant_from_numpy(
        np.asarray(op.circ.col), np.asarray(op.circ.spec), np.asarray(op.omega), device="cpu"
    )
    port = RecoveryProblem(port_op, torch.from_numpy(np.array(y)), torch.from_numpy(np.array(x)))
    return RefProblem(op=op, y=y, x_true=x), port


def test_ista_kernel_step_matches_pallas_step_unbatched():
    """5 steps of the port's kernel step vs the reference's Pallas step, with
    the reference test's parameters (n = 256, tau = 0.5)."""
    ref, port = _problems(256, (), seed=0)
    p_ref = RefIstaParams(alpha=jnp.float32(1e-4), tau=jnp.float32(0.5))
    p = ista.IstaParams(alpha=1e-4, tau=0.5)
    s_ref, s = ref_ista_init(ref.op, ref.y), ista.ista_init(port.op, port.y)
    for it in range(5):
        s_ref = ista_step_pallas(ref.op, ref.y, s_ref, p_ref, interpret=True)
        s = ista_step_kernel(port.op, port.y, s, p)
        np.testing.assert_allclose(s.x.numpy(), np.asarray(s_ref.x), atol=5e-5,
                                   err_msg=f"diverged at iteration {it}")


@pytest.mark.parametrize("n", [1024, 1 << 15])  # direct matvec; FFT branch
def test_ista_kernel_step_batched_matches_reference_jnp_step(n):
    """Batched: the reference's Pallas step raises on a batched y at both
    sizes (ROADMAP Queue 3), so the port is held against its jnp step, with
    the default step size computed on each side."""
    ref, port = _problems(n, (3,), seed=4)
    p_ref = RefIstaParams(alpha=jnp.float32(1e-4), tau=0.99 / ref.op.operator_norm_bound() ** 2)
    p = ista.IstaParams(alpha=1e-4, tau=ista.default_tau(port.op))
    s_ref, s = ref_ista_init(ref.op, ref.y), ista.ista_init(port.op, port.y)
    for it in range(5):
        s_ref = ref_ista_step(ref.op, ref.y, s_ref, p_ref)
        s = ista_step_kernel(port.op, port.y, s, p)
        for f in ("x", "x_prev", "t_mom"):
            np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(getattr(s_ref, f)),
                                       atol=5e-5, err_msg=f"{f} diverged at iteration {it}")


def test_solve_ista_on_kernel_tail_matches_reference():
    ref, port = _problems(1024, (3,), seed=7)
    x_ref, tr_ref = ref_solve(ref, "ista", iters=200, record_every=50, alpha=1e-4)
    x, tr = solve(port, "ista", iters=200, record_every=50, alpha=1e-4,
                  plan=plan(port.op, tail="kernel"))
    assert rel(x, x_ref) <= 1e-5
    assert rel(tr.objective, tr_ref.objective) <= 1e-5


@pytest.fixture
def counters():
    wrappers = (matvec_ops.circulant_matvec_direct, fused_ista_update)
    for w in wrappers:
        w.launches = 0
    return lambda: [w.launches for w in wrappers]


@pytest.mark.parametrize("method,tail,prox,kernel_steps", [
    ("ista", "kernel", None, True),
    ("cpista", "kernel", L1Prox(), True),
    ("ista", "plain", None, False),
    ("fista", "kernel", None, False),  # the reference has no kernel FISTA step
])
def test_make_stepper_routes_ista_to_the_kernel_step(method, tail, prox, kernel_steps,
                                                     monkeypatch, counters):
    from repro_torch.core import solvers

    calls = []
    kernel_step = solvers.ista_step_kernel
    monkeypatch.setattr(solvers, "ista_step_kernel",
                        lambda *a: calls.append(1) or kernel_step(*a))
    _, port = _problems(256, (2,), seed=12)
    x, _ = solve(port, method, iters=10, plan=plan(port.op, tail=tail, prox=prox))
    x_plain, _ = solve(port, method, iters=10)
    assert len(calls) == (10 if kernel_steps else 0)
    assert rel(x, x_plain.numpy()) <= 1e-6
    assert counters() == [0, 0]  # CPU tensors: the plain versions, no launch


class _NonNegShrink:
    """A non-l1 prior (one-sided shrink) standing in for the later slice's."""

    tag = "nonneg-test"

    def apply(self, x, gamma):
        return torch.clamp(x - gamma, min=0.0)


def test_non_l1_prior_keeps_the_plain_ista_step(monkeypatch):
    from repro_torch.core import solvers

    monkeypatch.setattr(solvers, "ista_step_kernel", lambda *a: pytest.fail("kernel step"))
    _, port = _problems(256, (2,), seed=13)
    x, _ = solve(port, "ista", iters=10, plan=plan(port.op, tail="kernel",
                                                   prox=_NonNegShrink()))
    x_plain, _ = solve(port, "ista", iters=10, prox=_NonNegShrink())
    assert torch.equal(x, x_plain) and bool((x >= 0).all())


def test_kernel_ista_step_needs_a_partial_circulant():
    _, port = _problems(256, (), seed=14)
    full = RecoveryProblem(port.op.circ, port.op.circ.matvec(port.x_true), port.x_true)
    with pytest.raises(TypeError, match="PartialCirculant"):
        solve(full, "ista", iters=1, plan=plan(full.op, tail="kernel"))


@pytest.mark.parametrize("tau_kind", ["tensor", "number"])
@pytest.mark.parametrize("n", [7, 1000, 4096])
def test_folded_ista_update_is_the_old_composition_bit_for_bit(n, tau_kind):
    """The folded kernel's plain version, eta_{alpha tau}(x + tau grad) in the
    kernel's order (the threshold and the step each rounded in float32, two
    shrink branches), equals the composition CPISTA launched before the
    fold: eta_gamma(x + delta) on delta = tau * grad, gamma = alpha * tau."""
    rng = np.random.default_rng(n)
    x, grad = (torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
               for _ in range(2))
    x[:, :2] = grad[:, :2] = 0.0  # sign(0)
    x[:, 2], grad[:, 2] = 0.003, 0.0  # inside the kill zone (alpha tau = 0.0037)
    alpha = 1e-2
    tau = torch.tensor(0.37) if tau_kind == "tensor" else 0.37
    tau32 = torch.as_tensor(tau, dtype=torch.float32)
    old = ista_threshold_update_ref(x, tau32 * grad, torch.tensor(alpha) * tau32)
    got = ista_step_update_ref(x, grad, tau, alpha)
    assert torch.equal(got, old)
    assert torch.equal(fused_ista_update(x, grad, alpha, tau=tau), old)
    assert int((got == 0).sum()) > 0  # the kill zone is exercised


def test_kernel_step_passes_the_raw_gradient(monkeypatch):
    """ista_step_kernel hands the fused update the gradient C^T r, the l1
    weight and the step itself: no tau * grad or alpha * tau of its own
    (two launches fewer a step on the card), and the plain step's numbers."""
    from repro_torch.core import kernel_backend

    seen = []
    real = kernel_backend.fused_ista_update
    monkeypatch.setattr(kernel_backend, "fused_ista_update",
                        lambda x, d, g, tau=None: seen.append((d, g, tau)) or real(x, d, g, tau=tau))
    _, port = _problems(256, (2,), seed=15)
    p = ista.IstaParams(alpha=1e-4, tau=ista.default_tau(port.op))
    s0 = ista.ista_init(port.op, port.y)
    s1 = ista.ista_step(port.op, port.y, s0, p)
    s1k = ista_step_kernel(port.op, port.y, s1, p)
    (delta, gamma, tau), = seen
    assert gamma == 1e-4 and tau is p.tau
    r = port.op.project_back(port.y - port.op.matvec(s1.x))
    assert rel(delta, port.op.circ.rmatvec(r).numpy()) <= 1e-5
    assert rel(s1k.x, ista.ista_step(port.op, port.y, s1, p).x.numpy()) <= 1e-5
