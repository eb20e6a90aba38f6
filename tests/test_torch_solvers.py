"""The port's CPADMM/ISTA/FISTA steps and drivers against the reference.

Operators, signals and measurements are built by ``repro`` and handed to
``repro_torch`` as numpy arrays.  The port runs on the CPU, where its
kernel step composes the kernels' plain versions.

Tolerances: 5e-5 absolute on 5-step state parity (the tolerance of
``tests/test_kernel_backend.py``); 1e-4 relative on x-hat for whole solves,
whose fp32 FFT rounding compounds over hundreds of iterations; equal
per-signal iteration counts for ``solve_until``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RecoveryProblem as RefProblem
from repro.core import solve as ref_solve
from repro.core import solve_until as ref_solve_until
from repro.core.admm import CpadmmParams as RefParams
from repro.core.admm import cpadmm_init as ref_init
from repro.core.admm import cpadmm_setup as ref_setup
from repro.core.admm import cpadmm_step as ref_step
from repro.core.circulant import partial_gaussian_circulant as ref_pgc
from repro.core.kernel_backend import cpadmm_step_pallas
from repro.data.synthetic import paper_regime as ref_regime
from repro.data.synthetic import sparse_signal as ref_sparse
from repro_torch import interop
from repro_torch.core import admm
from repro_torch.core.circulant import partial_gaussian_circulant
from repro_torch.core.kernel_backend import cpadmm_step_kernel
from repro_torch.core.solvers import (
    PAPER_TARGET_MSE,
    RecoveryProblem,
    make_stepper,
    rearm_slots,
    solve,
    solve_checkpointed,
    solve_until,
    until_init,
    until_step,
)
from repro_torch.data.synthetic import paper_regime, sparse_signal
from repro_torch.ops.plan import PlanConfig, plan, resolve_tail
from repro_torch.ops.prox import L1Prox, is_l1

FIELDS = ("x", "v", "z", "mu", "nu")


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


PARAMS = (1e-4, 0.01, 0.01, 1.0, 1.0)  # alpha, rho, sigma, tau1, tau2


def _step_pair(n, batch, seed):
    ref, port = _problems(n, batch, seed)
    p_ref = RefParams(*(jnp.float32(v) for v in PARAMS))
    p = admm.CpadmmParams(*PARAMS)
    return ref, port, p_ref, p, ref_setup(ref.op, ref.y, p_ref), admm.cpadmm_setup(port.op,
                                                                                port.y, p)


def test_kernel_step_matches_pallas_step_unbatched():
    """5 steps of the port's kernel step vs the reference's Pallas step."""
    ref, port, p_ref, p, c_ref, c = _step_pair(256, (), seed=3)
    s_ref, s = ref_init(ref.op, ref.y), admm.cpadmm_init(port.op, port.y)
    for it in range(5):
        s_ref = cpadmm_step_pallas(ref.op, c_ref, s_ref, p_ref, interpret=True)
        s = cpadmm_step_kernel(port.op, c, s, p)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(getattr(s_ref, f)),
                                       atol=5e-5, err_msg=f"{f} diverged at iteration {it}")


@pytest.mark.parametrize("step", ["kernel", "plain"])
def test_batched_steps_match_reference_jnp_step(step):
    """Batched: the reference's Pallas tail cannot take a batch below 2^15
    (ROADMAP Queue 3), so the port is held against its jnp step."""
    ref, port, p_ref, p, c_ref, c = _step_pair(256, (3,), seed=5)
    s_ref, s = ref_init(ref.op, ref.y), admm.cpadmm_init(port.op, port.y)
    for it in range(5):
        s_ref = ref_step(ref.op, c_ref, s_ref, p_ref)
        s = cpadmm_step_kernel(port.op, c, s, p) if step == "kernel" else admm.cpadmm_step(
            port.op, c, s, p)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(getattr(s_ref, f)),
                                       atol=5e-5, err_msg=f"{f} diverged at iteration {it}")


def test_cpadmm_state_interop_round_trip():
    ref, port, p_ref, p, c_ref, c = _step_pair(256, (2,), seed=6)
    s_ref = ref_step(ref.op, c_ref, ref_init(ref.op, ref.y), p_ref)
    s = interop.cpadmm_state_from_numpy(*(np.asarray(a) for a in s_ref), device="cpu")
    nxt_ref = ref_step(ref.op, c_ref, s_ref, p_ref)
    nxt = admm.cpadmm_step(port.op, c, s, p)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(nxt, f).numpy(), np.asarray(getattr(nxt_ref, f)),
                                   atol=5e-5)


SOLVE_CASES = [
    ("cpadmm", dict(alpha=1e-4, rho=0.01, sigma=0.01), "plain"),
    ("cpadmm", dict(alpha=1e-4, rho=0.01, sigma=0.01), "kernel"),
    ("ista", dict(alpha=1e-4), "plain"),
    ("fista", dict(alpha=1e-4), "plain"),
]
# FISTA's momentum transiently amplifies FFT rounding (1e-3 apart at 400
# iterations, 6e-7 at 800), so it is compared at convergence, with the
# quickstart's FISTA budget, as the reference's own plan tests pin it
SOLVE_ITERS = {"cpadmm": 200, "ista": 200, "fista": 800}


@pytest.mark.parametrize("method,kw,tail", SOLVE_CASES)
def test_solve_matches_reference(method, kw, tail):
    ref, port = _problems(1024, (3,), seed=7)
    iters = SOLVE_ITERS[method]
    x_ref, tr_ref = ref_solve(ref, method, iters=iters, record_every=iters // 4, **kw)
    x, tr = solve(port, method, iters=iters, record_every=iters // 4,
                  plan=plan(port.op, tail=tail), **kw)
    assert rel(x, x_ref) <= 1e-4
    assert rel(tr.mse, tr_ref.mse) <= 1e-3  # an MSE near 1e-7 is a difference of two near-equals
    assert rel(tr.objective, tr_ref.objective) <= 1e-4
    assert tr.nnz.shape == tr_ref.nnz.shape == (4, 3)


# FISTA again runs past its momentum transient (tol 1e-5, ~640-720 iterations
# here).  Its relative change is not monotone, so where it hovers near tol
# an fp32 rounding difference can move the stop by an iteration; ROADMAP
# Queue 3 records this sensitivity.
UNTIL = {
    "cpadmm": dict(tol=1e-4, max_iters=400, min_iters=20),
    "ista": dict(tol=1e-4, max_iters=400, min_iters=20),
    "fista": dict(tol=1e-5, max_iters=1000, min_iters=20),
}


@pytest.mark.parametrize("method,kw,tail", SOLVE_CASES)
def test_solve_until_matches_reference(method, kw, tail):
    ref, port = _problems(1024, (3,), seed=8)
    until = UNTIL[method]
    x_ref, it_ref = ref_solve_until(ref, method, **until, **kw)
    x, its = solve_until(port, method, plan=plan(port.op, tail=tail), **until, **kw)
    np.testing.assert_array_equal(its.numpy(), np.asarray(it_ref))
    assert rel(x, x_ref) <= 1e-4


def test_quickstart_config_recovers_and_matches_reference():
    """examples/quickstart.py: n = 4096, 400 CPADMM iterations."""
    ref, port = _problems(4096, (), seed=0)
    kw = dict(alpha=1e-4, rho=0.01, sigma=0.01)
    x_ref, tr_ref = ref_solve(ref, "cpadmm", iters=400, record_every=100, **kw)
    x, tr = solve(port, "cpadmm", iters=400, record_every=100, **kw)
    assert float(tr.mse[-1]) <= PAPER_TARGET_MSE
    assert rel(x, x_ref) <= 1e-4


@pytest.mark.parametrize("method", ["cpadmm", "fista"])
def test_batch_of_one_equals_unbatched(method):
    """The port's own generator-built problem: batch of 1 == unbatched."""
    g = torch.Generator().manual_seed(0)
    n = 512
    m, k = paper_regime(n)
    x_true = sparse_signal(g, n, k, device="cpu")
    op = partial_gaussian_circulant(g, n, m, normalize=True, device="cpu")
    prob = RecoveryProblem(op, op.matvec(x_true), x_true)
    prob1 = RecoveryProblem(op, prob.y[None], x_true[None])
    kw = dict(rho=0.01, sigma=0.01) if method == "cpadmm" else {}
    x, _ = solve(prob, method, iters=50, **kw)
    x1, _ = solve(prob1, method, iters=50, **kw)
    assert rel(x1[0], x.numpy()) <= 1e-6
    xu, iu = solve_until(prob, method, tol=1e-4, max_iters=300, **kw)
    xu1, iu1 = solve_until(prob1, method, tol=1e-4, max_iters=300, **kw)
    assert int(iu) == int(iu1[0])
    assert rel(xu1[0], xu.numpy()) <= 1e-6


def test_rearmed_slot_runs_as_if_alone():
    """until_step / rearm_slots: a slot admitted mid-run matches a solo run."""
    _, port = _problems(256, (2,), seed=9)
    stepper = make_stepper(port, "fista", alpha=1e-4)
    u, batch = until_init(stepper)
    for _ in range(7):
        u = until_step(stepper, u, 0.0, 0, 100, batch)
    u = rearm_slots(u, until_init(stepper)[0], torch.tensor([False, True]), batch)
    for _ in range(5):
        u = until_step(stepper, u, 0.0, 0, 100, batch)
    solo, _ = solve(RecoveryProblem(port.op, port.y[1:], port.x_true[1:]), "fista", iters=5)
    assert u.age.tolist() == [12, 5]
    assert rel(u.state.x[1], solo[0].numpy()) <= 1e-6


def test_solve_checkpointed_resumes_exactly():
    _, port = _problems(256, (2,), seed=10)
    kw = dict(rho=0.01, sigma=0.01)
    saved = {}
    x_full, mse = solve_checkpointed(port, "cpadmm", iters=60, chunk=20,
                                     save_cb=lambda step, s: saved.__setitem__(step, s), **kw)
    assert sorted(saved) == [20, 40, 60]
    x_resumed, _ = solve_checkpointed(port, "cpadmm", iters=60, chunk=20,
                                      restore=(40, saved[40]), **kw)
    assert torch.equal(x_full, x_resumed)
    x_solve, _ = solve(port, "cpadmm", iters=60, record_every=60, **kw)
    assert torch.equal(x_full, x_solve)
    assert mse.shape == (2,)


def test_plan_layer_validates_and_routes():
    _, port = _problems(256, (), seed=11)
    assert plan(port.op).tail == "plain" and not plan(port.op).is_distributed
    assert plan(port.op, tail="kernel").config == PlanConfig(tail="kernel")
    assert plan(port.op, tail="kernel").tail == "kernel"
    assert plan(port.op).operator is port.op
    with pytest.raises(ValueError, match="tail must be one of"):
        plan(port.op, tail="pallas")
    with pytest.raises(ValueError, match="prox must be"):
        plan(port.op, prox=object())
    with pytest.raises(TypeError, match="Mesh"):
        plan(port.op, mesh=object())
    with pytest.raises(TypeError, match="dense ADMM needs a DenseOperator"):
        make_stepper(port, "admm")
    with pytest.raises(ValueError, match="valid methods"):
        make_stepper(port, "nope")


class _NonNegShrink:
    """A non-l1 prior (one-sided shrink) standing in for the later slice's."""

    tag = "nonneg-test"

    def apply(self, x, gamma):
        return torch.clamp(x - gamma, min=0.0)


def test_prox_routes_the_kernel_tail(monkeypatch):
    """tail='kernel' with the l1 prior (None or L1Prox) takes the kernel step;
    another prior takes the plain step with its own z-update."""
    from repro_torch.core import solvers

    calls = []
    kernel_step = solvers.cpadmm_step_kernel
    monkeypatch.setattr(solvers, "cpadmm_step_kernel",
                        lambda *a: calls.append(1) or kernel_step(*a))
    _, port = _problems(256, (2,), seed=12)
    kw = dict(iters=20, rho=0.01, sigma=0.01)
    assert is_l1(None) and is_l1(L1Prox()) and not is_l1(_NonNegShrink())
    x_plain, _ = solve(port, "cpadmm", **kw)
    assert not calls
    x_l1, _ = solve(port, "cpadmm", plan=plan(port.op, tail="kernel", prox=L1Prox()), **kw)
    assert len(calls) == 20
    assert rel(x_l1, x_plain.numpy()) <= 1e-6
    x_nn, _ = solve(port, "cpadmm", plan=plan(port.op, tail="kernel", prox=_NonNegShrink()),
                    **kw)
    x_nn_plain, _ = solve(port, "cpadmm", prox=_NonNegShrink(), **kw)
    assert len(calls) == 20
    assert torch.equal(x_nn, x_nn_plain) and bool((x_nn >= 0).all())


CUDA = torch.device("cuda")


@pytest.mark.parametrize("tail,family,device,want", [
    (None, "partial", None, "plain"),  # the operator's own device: the CPU
    (None, "partial", CUDA, "kernel"),  # operands on the card: the kernel steps
    (None, "partial", "cuda:1", "kernel"),
    (None, "circulant", CUDA, "plain"),  # no kernel step takes a full circulant
    (None, "dense", CUDA, "plain"),  # nor a dense operator (PADMM asks by name)
    (None, "mesh", CUDA, "kernel"),  # a mesh rank's blocks on the card
    (None, "mesh", torch.device("cpu"), "plain"),
    ("plain", "partial", CUDA, "plain"),  # an explicit tail is kept
    ("kernel", "dense", None, "kernel"),
])
def test_resolve_tail_chooses_the_step_from_the_operands_device(tail, family, device, want):
    """The plan's default tail, resolved by a pure helper: no card needed to
    ask what a CUDA operand would get."""
    from repro_torch.core.circulant import densify

    _, port = _problems(64, (), seed=16)
    op = {"partial": port.op, "circulant": port.op.circ, "dense": densify(port.op),
          "mesh": None}[family]
    assert resolve_tail(tail, op, device=device) == want


def test_plan_resolves_its_tail_when_built(monkeypatch):
    """plan(op), build_deblur_plan(problem) and a stepper with no plan take
    the resolved tail: the plain step for CPU operands, the kernel step for
    a PartialCirculant on the card (the device faked through the helper)."""
    from repro_torch.core import deblur, solvers
    from repro_torch.ops import plan as plan_mod

    _, port = _problems(256, (2,), seed=17)
    assert plan(port.op).config == PlanConfig(tail="plain")
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, 16, 16, generator=g)
    dp = deblur.build_multiframe_deblur_problem(g, images)
    assert deblur.build_deblur_plan(dp).tail == "plain"
    assert deblur.build_deblur_plan(dp, tail="kernel").tail == "kernel"

    real = plan_mod.resolve_tail
    on_card = lambda tail, op=None, device=None: real(tail, op, device=CUDA)
    monkeypatch.setattr(plan_mod, "resolve_tail", on_card)
    monkeypatch.setattr(solvers, "resolve_tail", on_card)
    assert plan(port.op).tail == "kernel" and deblur.build_deblur_plan(dp).tail == "kernel"
    assert plan(port.op.circ).tail == "plain"
    calls = []
    kernel_step = solvers.cpadmm_step_kernel
    monkeypatch.setattr(solvers, "cpadmm_step_kernel",
                        lambda *a: calls.append(1) or kernel_step(*a))
    x_default, _ = solve(port, "cpadmm", iters=5, rho=0.01, sigma=0.01)
    x_kernel, _ = solve(port, "cpadmm", iters=5, rho=0.01, sigma=0.01,
                        plan=plan(port.op, tail="kernel"))
    assert len(calls) == 10 and torch.equal(x_default, x_kernel)
