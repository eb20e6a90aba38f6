"""The port's priors (``repro_torch.ops.prox``) against the reference's.

Mirrors ``tests/test_prox.py``: the operator properties (non-expansive,
batched == looped, TV's and the wavelet's fixed points and adjoints),
validation, serialization, the solver threading (``prox=None`` and
``L1Prox()`` bit-equal, the kernel tail taken only under l1) and the
planned mesh per prior.  Every input is drawn by the reference and carried
across through numpy; every result is held against the reference's
computed output: l1 and non-negative l1 bit for bit, TV and wavelet within
1e-6 relative, solves within 1e-5.  The mesh cases run on 1, 2 and 2x2 gloo
ranks (``spawn_fake_devices``), one spawned program per mesh shape.

The reference's tuner and serve cases (``test_tuner_candidates_carry_prox_
pin``, ``test_serve_buckets_split_on_prox``) close the file.  The decode
cases live in ``tests/test_torch_compression.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_programs import prox_mesh_program

import repro.ops.prox as ref_prox
from repro.core import RecoveryProblem as RefProblem
from repro.core import partial_gaussian_circulant as ref_pgc
from repro.core import solve as ref_solve
from repro.data.synthetic import paper_regime
from repro.data.synthetic import sparse_signal as ref_sparse
from repro_torch import interop
from repro_torch.core import soft_threshold
from repro_torch.core.solvers import RecoveryProblem, make_stepper, solve
from repro_torch.dist.compat import spawn_fake_devices
from repro_torch.ops.plan import PlanConfig, plan
from repro_torch.ops.prox import (
    PROX_KINDS,
    L1Prox,
    NonNegL1Prox,
    TVProx,
    WaveletProx,
    is_elementwise,
    is_l1,
    prox_from_dict,
    prox_to_dict,
)

SOLVE_KW = dict(alpha=1e-3, rho=0.01, sigma=0.01)
METHODS = ("ista", "fista", "cpadmm")
PAIRS = [  # (port prox, reference prox)
    (L1Prox(), ref_prox.L1Prox()),
    (NonNegL1Prox(), ref_prox.NonNegL1Prox()),
    (TVProx(shape=(8, 8)), ref_prox.TVProx(shape=(8, 8))),
    (WaveletProx(levels=2, wavelet="haar"), ref_prox.WaveletProx(levels=2, wavelet="haar")),
    (WaveletProx(levels=1, wavelet="db4"), ref_prox.WaveletProx(levels=1, wavelet="db4")),
]
ALL_PROXES = [p for p, _ in PAIRS]
EXACT = ("l1", "nonneg-l1")  # bit-equal to the reference; TV and wavelet within 1e-6


def _ids(proxes):
    return [p.tag for p in proxes]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_problem(n=256, batch=2, seed=0):
    m, k = paper_regime(n)
    x_true = ref_sparse(jax.random.PRNGKey(seed), n, k, batch=(batch,))
    op = ref_pgc(jax.random.PRNGKey(seed + 1), n, m, normalize=True)
    return RefProblem(op=op, y=op.matvec(x_true), x_true=x_true)


def _carry(ref) -> RecoveryProblem:
    a = np.asarray
    op = interop.partial_circulant_from_numpy(a(ref.op.circ.col), a(ref.op.circ.spec),
                                              a(ref.op.omega), device="cpu")
    return RecoveryProblem(op=op, y=_t(ref.y), x_true=_t(ref.x_true))


@pytest.fixture(scope="module")
def problems():
    ref = _ref_problem()
    return ref, _carry(ref)


# -- against the reference --------------------------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=_ids(ALL_PROXES))
@pytest.mark.parametrize("batched", [False, True])
def test_prox_apply_matches_reference(pair, batched):
    prox, ref = pair
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (3, 64) if batched else (64,))) * 2
    for gamma in (0.0, 0.05, 0.3):
        got, want = prox.apply(_t(x), gamma), ref.apply(jnp.asarray(x), gamma)
        if prox.tag in EXACT:
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        else:
            assert _rel(got, want) <= 1e-6, (prox.tag, gamma)
    # a 0-dimensional tensor gamma (ISTA's alpha * tau) gives the same numbers
    np.testing.assert_array_equal(_np(prox.apply(_t(x), torch.tensor(0.05))),
                                  _np(prox.apply(_t(x), 0.05)))


@pytest.mark.parametrize("pair", PAIRS[2:], ids=_ids(ALL_PROXES[2:]))
def test_analysis_pair_matches_reference(pair):
    prox, ref = pair
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(10), (2, 64)))
    assert _rel(prox.analysis_op(_t(x)), ref.analysis_op(jnp.asarray(x))) <= 1e-6
    c = np.asarray(ref.analysis_op(jnp.asarray(x)))
    assert _rel(prox.analysis_rmatvec(_t(c)), ref.analysis_rmatvec(jnp.asarray(c))) <= 1e-6


def test_roll_shares_the_reference_sign_convention():
    """TV's periodic differences and the wavelet's filters are rolls:
    torch.roll and jnp.roll move a positive shift the same way, on both
    axes of the frame."""
    img = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    for shift in (1, -1, 2):
        for axis in (-2, -1):
            np.testing.assert_array_equal(
                torch.roll(_t(img), shift, dims=axis).numpy(),
                np.asarray(jnp.roll(jnp.asarray(img), shift, axis=axis)))


# -- operator properties ----------------------------------------------------


@pytest.mark.parametrize("prox", ALL_PROXES, ids=_ids(ALL_PROXES))
def test_prox_nonexpansive(prox):
    """||prox(x) - prox(y)|| <= ||x - y||: definitional for the prox of a
    convex function."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    for gamma in (0.01, 0.3):
        x, y = _t(jax.random.normal(k1, (64,))), _t(jax.random.normal(k2, (64,)))
        lhs = float((prox.apply(x, gamma) - prox.apply(y, gamma)).norm())
        assert lhs <= float((x - y).norm()) * (1 + 1e-5), (prox.tag, gamma)


@pytest.mark.parametrize("prox", ALL_PROXES, ids=_ids(ALL_PROXES))
def test_prox_batched_equals_loop(prox):
    x = _t(jax.random.normal(jax.random.PRNGKey(5), (3, 64)))
    want = torch.stack([prox.apply(x[i], 0.1) for i in range(3)])
    assert torch.equal(prox.apply(x, 0.1), want)


def test_l1_prox_is_soft_threshold_bitwise():
    x = _t(jax.random.normal(jax.random.PRNGKey(0), (4, 128))) * 2.0
    for gamma in (0.0, 0.05, 1.5):
        assert torch.equal(L1Prox().apply(x, gamma), soft_threshold(x, gamma))


def test_nonneg_l1_prox():
    got = NonNegL1Prox().apply(torch.tensor([-1.0, -0.05, 0.05, 1.0, float("nan")]), 0.1)
    np.testing.assert_allclose(got[:4].numpy(), [0.0, 0.0, 0.0, 0.9], atol=1e-7)
    assert (got[:4] >= 0).all() and torch.isnan(got[4])  # NaN kept, as jnp.maximum keeps it


def test_tv_prox_constant_fixed_point():
    x = torch.full((64,), 0.7)
    np.testing.assert_allclose(TVProx(shape=(8, 8)).apply(x, 0.5).numpy(), x.numpy(),
                               atol=1e-6)


def test_tv_prox_reduces_tv_norm():
    prox = TVProx(shape=(8, 8), iters=20)
    x = _t(jax.random.normal(jax.random.PRNGKey(1), (64,)))

    def tv(v):
        img = v.reshape(8, 8)
        return float((torch.roll(img, -1, 0) - img).abs().sum()
                     + (torch.roll(img, -1, 1) - img).abs().sum())

    assert tv(prox.apply(x, 0.2)) < tv(x)


def test_tv_analysis_adjoint():
    """<D x, p> == <x, D^T p>."""
    prox = TVProx(shape=(8, 8))
    kx, kp = jax.random.split(jax.random.PRNGKey(2))
    x, p = _t(jax.random.normal(kx, (64,))), _t(jax.random.normal(kp, (128,)))
    lhs = float(torch.dot(prox.analysis_op(x), p))
    assert lhs == pytest.approx(float(torch.dot(x, prox.analysis_rmatvec(p))), rel=1e-5)


@pytest.mark.parametrize("wavelet", ["haar", "db4"])
def test_wavelet_prox_perfect_reconstruction(wavelet):
    """gamma = 0 thresholds nothing: W^T W x == x (orthonormal filter bank)."""
    prox = WaveletProx(levels=2, wavelet=wavelet)
    x = _t(jax.random.normal(jax.random.PRNGKey(4), (64,)))
    np.testing.assert_allclose(prox.apply(x, 0.0).numpy(), x.numpy(), atol=2e-6)
    c = prox.analysis_op(x)
    assert float(torch.dot(c, c)) == pytest.approx(float(torch.dot(x, x)), rel=1e-5)
    np.testing.assert_allclose(prox.analysis_rmatvec(c).numpy(), x.numpy(), atol=2e-6)


def test_wavelet_up_leaves_its_input_alone():
    """The adjoint's scatter writes into a fresh array, never a caller's."""
    c = torch.arange(4.0)
    before = c.clone()
    WaveletProx._up(c, (0.5, 0.5), 8)
    assert torch.equal(c, before)


def test_prox_validation_errors():
    with pytest.raises(ValueError, match="shape"):
        TVProx(shape=(0, 8))
    with pytest.raises(ValueError, match="iters"):
        TVProx(shape=(8, 8), iters=0)
    with pytest.raises(ValueError, match="wavelet"):
        WaveletProx(wavelet="sym9")
    with pytest.raises(ValueError, match="levels"):
        WaveletProx(levels=0)
    with pytest.raises(ValueError):
        TVProx(shape=(8, 8)).apply(torch.zeros(63), 0.1)
    with pytest.raises(ValueError):
        WaveletProx(levels=3).apply(torch.zeros(12), 0.1)


# -- registry and serialization ----------------------------------------------


def test_prox_serialization_round_trip():
    for prox in ALL_PROXES:
        d = prox_to_dict(prox)
        json.dumps(d)
        back = prox_from_dict(d)
        assert back == prox and type(back) is type(prox)
    assert prox_to_dict(None) is None and prox_from_dict(None) is None
    assert set(PROX_KINDS) == {"l1", "nonneg-l1", "tv", "wavelet"}
    with pytest.raises(ValueError, match="kind"):
        prox_from_dict({"kind": "nope"})


@pytest.mark.parametrize("pair", PAIRS, ids=_ids(ALL_PROXES))
def test_prox_dicts_cross_between_the_packages(pair):
    """The reference's dict rebuilds the port's prox, and the port's dict the
    reference's: the same kinds, fields and tags."""
    prox, ref = pair
    assert interop.prox_from_reference_dict(json.loads(json.dumps(ref.to_dict()))) == prox
    assert ref_prox.prox_from_dict(json.loads(json.dumps(prox.to_dict()))) == ref
    assert prox.to_dict() == ref.to_dict() and prox.tag == ref.tag


def test_prox_helpers_and_hashability():
    assert is_l1(None) and is_l1(L1Prox())
    assert not is_l1(TVProx(shape=(4, 4))) and not is_l1(NonNegL1Prox())
    assert is_elementwise(None) and is_elementwise(NonNegL1Prox())
    assert not is_elementwise(TVProx(shape=(4, 4)))
    assert not is_elementwise(WaveletProx())
    assert len({L1Prox(), L1Prox(), TVProx(shape=(4, 4))}) == 2


# -- solver threading ---------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_solver_none_vs_l1prox_bitwise(method, problems):
    _, prob = problems
    x0, _ = solve(prob, method, iters=40, record_every=40, plan=plan(prob.op), **SOLVE_KW)
    x1, _ = solve(prob, method, iters=40, record_every=40, plan=plan(prob.op, prox=L1Prox()),
                  **SOLVE_KW)
    assert torch.equal(x0, x1)


def test_cpadmm_kernel_tail_l1_only(problems, monkeypatch):
    """tail='kernel' takes the fused kernel tail under l1 (its plain version
    on the CPU, within 1e-6 of the plain step) and the plain tail under any
    other prior, bit-equal to tail='plain'."""
    import repro_torch.core.solvers as solvers_mod

    _, prob = problems
    prob = RecoveryProblem(op=prob.op, y=prob.y[0], x_true=prob.x_true[0])
    kw = dict(iters=20, record_every=20, **SOLVE_KW)
    x_p, _ = solve(prob, "cpadmm", plan=plan(prob.op, tail="plain"), **kw)
    x_k, _ = solve(prob, "cpadmm", plan=plan(prob.op, tail="kernel"), **kw)
    assert _rel(x_k, x_p) < 1e-6
    calls = []
    real = solvers_mod.cpadmm_step_kernel
    monkeypatch.setattr(solvers_mod, "cpadmm_step_kernel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    solve(prob, "cpadmm", plan=plan(prob.op, tail="kernel"), **kw)
    assert len(calls) == 20
    calls.clear()
    prox = NonNegL1Prox()
    x_f, _ = solve(prob, "cpadmm", plan=plan(prob.op, tail="kernel"), prox=prox, **kw)
    x_r, _ = solve(prob, "cpadmm", plan=plan(prob.op, tail="plain"), prox=prox, **kw)
    assert not calls and torch.equal(x_f, x_r) and float(x_f.min()) >= 0.0


@pytest.mark.parametrize("pair", [PAIRS[1], (TVProx(shape=(16, 16)),
                                             ref_prox.TVProx(shape=(16, 16))),
                                  (WaveletProx(), ref_prox.WaveletProx())],
                         ids=["nonneg-l1", "tv", "wavelet"])
@pytest.mark.parametrize("method", METHODS)
def test_solver_non_l1_proxes_match_reference(method, pair, problems):
    """Each prior's solve against the reference's solve of the same problem
    (and the prior engaged: the result differs from the l1 solve)."""
    prox, ref = pair
    ref_prob, prob = problems
    x, _ = solve(prob, method, iters=40, record_every=40, plan=plan(prob.op, prox=prox),
                 **SOLVE_KW)
    x_ref, _ = ref_solve(ref_prob, method, iters=40, record_every=40, prox=ref, **SOLVE_KW)
    assert bool(torch.isfinite(x).all())
    assert _rel(x, x_ref) <= 1e-5, (method, prox.tag)
    x_l1, _ = solve(prob, method, iters=40, record_every=40, plan=plan(prob.op), **SOLVE_KW)
    assert not torch.equal(x, x_l1)


def test_make_stepper_prox_defaults_to_plan(problems):
    _, prob = problems
    pl = plan(prob.op, prox=NonNegL1Prox())
    st = make_stepper(prob, "cpadmm", plan=pl, **SOLVE_KW)
    s = st.init()
    for _ in range(10):
        s = st.step(s)
    assert float(st.extract(s).min()) >= 0.0
    st2 = make_stepper(prob, "cpadmm", plan=pl, prox=L1Prox(), **SOLVE_KW)
    st3 = make_stepper(prob, "cpadmm", plan=plan(prob.op), **SOLVE_KW)
    s2, s3 = st2.init(), st3.init()
    for _ in range(10):
        s2, s3 = st2.step(s2), st3.step(s3)
    assert torch.equal(st2.extract(s2), st3.extract(s3))


def test_plan_config_prox_validation_and_describe():
    cfg = PlanConfig(prox=TVProx(shape=(8, 8), iters=5))
    cfg.validate(distributed=False)
    assert "prox=tv[8x8,it5]" in cfg.describe()
    assert "prox=" not in PlanConfig().describe()
    with pytest.raises(ValueError, match="prox"):
        PlanConfig(prox="tv").validate(distributed=False)
    back = PlanConfig.from_dict(cfg.to_dict())
    assert back.prox == cfg.prox
    json.dumps(cfg.to_dict())


# -- the planned mesh per prior ------------------------------------------------

MESH_PRIORS = {
    "none": None, "l1": L1Prox(), "nonneg-l1": NonNegL1Prox(),
    "tv": TVProx(shape=(16, 16)), "wavelet": WaveletProx(),
}
MESH_SHAPES = {"1": (1,), "2": (2,), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def mesh_runs(problems):
    ref, _ = problems
    a = dict(col=np.asarray(ref.op.circ.col), spec=np.asarray(ref.op.circ.spec),
             omega=np.asarray(ref.op.omega), y=np.asarray(ref.y),
             x_true=np.asarray(ref.x_true))
    return {key: spawn_fake_devices(int(np.prod(shape)), prox_mesh_program, a, shape,
                                    MESH_PRIORS, SOLVE_KW)[0]
            for key, shape in MESH_SHAPES.items()}


@pytest.mark.parametrize("prior", sorted(MESH_PRIORS))
@pytest.mark.parametrize("method", ("ista", "cpadmm"))
@pytest.mark.parametrize("mesh", sorted(MESH_SHAPES))
def test_planned_mesh_matches_local_per_prior(mesh, method, prior, mesh_runs):
    r = mesh_runs[mesh]
    assert _rel(r[prior, method], r[prior, method, "local"]) <= 1e-5, (mesh, method, prior)


@pytest.mark.parametrize("mesh", sorted(MESH_SHAPES))
def test_planned_mesh_none_vs_l1_bitwise_and_hybrid_unfused(mesh, mesh_runs):
    r = mesh_runs[mesh]
    for method in ("ista", "cpadmm"):
        assert torch.equal(r["none", method], r["l1", method])
    assert torch.equal(r["tv", "unfused"], r["tv", "cpadmm"])


# -- the tuner and the server -------------------------------------------------


def test_tuner_candidates_carry_prox_pin(problems):
    from repro_torch.dist.compat import Mesh
    from repro_torch.ops.tune import cache_key, candidate_configs

    # a mesh's names and extents alone: all that enumeration and the key read
    mesh = Mesh(("model",), (1,), (0,), (None,), torch.device("cpu"))
    op = problems[1].op
    prox = TVProx(shape=(16, 16))
    cands = candidate_configs(op, mesh, pins={"prox": prox})
    assert cands and all(c.prox == prox for c in cands)
    # distinct prox pins key distinct store entries
    k_tv = cache_key(op, mesh, 2, {"prox": prox})
    k_l1 = cache_key(op, mesh, 2, {"prox": L1Prox()})
    k_none = cache_key(op, mesh, 2, {})
    assert len({k_tv, k_l1, k_none}) == 3


def test_serve_buckets_split_on_prox(problems):
    """Requests differing only in the plan config's prox never share an engine."""
    from repro_torch.serve import RecoveryRequest, RecoveryServer

    op = problems[1].op
    y = torch.zeros((op.m,))
    server = RecoveryServer(slots=2)

    def req(rid, cfg):
        return RecoveryRequest(request_id=rid, op=op, y=y, plan_config=cfg)

    k_l1 = server.bucket_key(req("a", PlanConfig()))
    k_tv = server.bucket_key(req("b", PlanConfig(prox=TVProx(shape=(16, 16)))))
    k_wv = server.bucket_key(req("c", PlanConfig(prox=WaveletProx())))
    assert len({k_l1, k_tv, k_wv}) == 3
