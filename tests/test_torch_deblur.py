"""Sec. 7 compressed deblurring on the port against the reference.

The reference builds the frame stack and the joint operator ``A = P (C B)``;
``repro_torch.interop.deblur_problem_from_numpy`` carries them across with
the stored composed spectrum as given.  Both sides then run CPADMM.

Tolerance: 1e-4 relative on x-hat and on every ``deblur_metrics`` entry
after 100 iterations (fp32 FFT rounding compounds over the iterations).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RecoveryProblem as RefProblem
from repro.core import solve as ref_solve
from repro.core.deblur import blurred_observation as ref_blurred
from repro.core.deblur import build_deblur_problem as ref_build_single
from repro.core.deblur import build_multiframe_deblur_problem as ref_build
from repro.core.deblur import deblur_metrics as ref_metrics
from repro.data.synthetic import starfield as ref_starfield
from repro_torch import interop
from repro_torch.core.deblur import (
    blurred_observation,
    build_deblur_plan,
    build_deblur_problem,
    build_multiframe_deblur_problem,
    deblur_metrics,
    recovered_image,
)
from repro_torch.core.solvers import RecoveryProblem, solve
from repro_torch.data.synthetic import starfield

SOLVE_KW = dict(alpha=1e-3, rho=0.01, sigma=0.01)


def rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _carry(p):
    a = np.asarray
    return interop.deblur_problem_from_numpy(
        a(p.op.circ.col), a(p.op.circ.spec), a(p.op.omega), a(p.blur.col), a(p.blur.spec),
        a(p.y), a(p.image), device="cpu",
    )


def _frames(size=32, frames=2):
    keys = jax.random.split(jax.random.PRNGKey(0), frames)
    return jnp.stack([ref_starfield(k, size, size, density=0.08, n_blobs=3) for k in keys])


@pytest.mark.parametrize("blur_kind,order", [("moving-average", 5), ("gaussian", 1.0)])
@pytest.mark.parametrize("tail", ["plain", "kernel"])
def test_multiframe_deblur_matches_reference(blur_kind, order, tail):
    ref = ref_build(jax.random.PRNGKey(1), _frames(), blur_order=order, sensing="romberg",
                    blur_kind=blur_kind)
    port = _carry(ref)
    frames = ref.image.shape[0]
    x_ref, _ = ref_solve(RefProblem(ref.op, ref.y, ref.image.reshape(frames, -1)), "cpadmm",
                         iters=100, record_every=100, **SOLVE_KW)
    prob = RecoveryProblem(port.op, port.y, port.image.reshape(frames, -1))
    x, _ = solve(prob, "cpadmm", iters=100, record_every=100,
                 plan=build_deblur_plan(port, tail=tail), **SOLVE_KW)
    assert rel(x, x_ref) <= 1e-4
    m_ref, m = ref_metrics(ref, x_ref), deblur_metrics(port, x)
    assert sorted(m) == sorted(m_ref)
    for key in m_ref:
        assert m[key].shape == (frames,)
        assert rel(m[key], m_ref[key]) <= 1e-4, key
    assert rel(blurred_observation(port), ref_blurred(ref)) <= 1e-5
    assert recovered_image(port, x).shape == (frames, 32, 32)


def test_single_frame_operator_matches_reference():
    ref = ref_build_single(jax.random.PRNGKey(2), _frames(frames=1)[0], blur_order=5)
    port = _carry(ref)
    x = np.random.default_rng(0).standard_normal(32 * 32).astype(np.float32)
    assert rel(port.op.matvec(torch.from_numpy(x)), ref.op.matvec(jnp.asarray(x))) <= 1e-5
    assert rel(port.op.rmatvec(port.y), ref.op.rmatvec(ref.y)) <= 1e-5


def test_deblur_metrics_degenerate_frame_psnr():
    """An all-zero frame has no peak to reference: PSNR is the -inf sentinel,
    exactly as the reference reports it."""
    images = jnp.stack([jnp.zeros((8, 8)), jnp.ones((8, 8))])
    ref = ref_build(jax.random.PRNGKey(3), images, blur_order=2)
    port = _carry(ref)
    x = np.full((2, 64), 0.5, np.float32)
    m, m_ref = deblur_metrics(port, torch.from_numpy(x)), ref_metrics(ref, jnp.asarray(x))
    assert math.isinf(float(m["psnr_db"][0])) and float(m["psnr_db"][0]) < 0
    assert float(m_ref["psnr_db"][0]) == float(m["psnr_db"][0])
    assert rel(m["psnr_db"][1:], m_ref["psnr_db"][1:]) <= 1e-5
    assert all(bool(torch.isfinite(v).all()) for k, v in m.items() if k != "psnr_db")


def test_port_builders_make_a_recoverable_problem():
    """The port's own generator-driven builders (no reference inputs)."""
    g = torch.Generator().manual_seed(0)
    images = torch.stack([starfield(g, 32, 32, density=0.08, n_blobs=3, device="cpu")
                          for _ in range(2)])
    p = build_multiframe_deblur_problem(g, images, blur_order=5, sensing="romberg")
    assert p.y.shape == (2, 512) and p.op.shape == (512, 1024)
    x, _ = solve(RecoveryProblem(p.op, p.y, images.reshape(2, -1)), "cpadmm", iters=400,
                 record_every=400, **SOLVE_KW)
    psnr = deblur_metrics(p, x)["psnr_db"]
    blurred = deblur_metrics(p, blurred_observation(p).reshape(2, -1))["psnr_db"]
    assert bool((psnr > blurred + 10.0).all()), (psnr, blurred)
    with pytest.raises(ValueError, match="single"):
        build_deblur_problem(g, images)
    with pytest.raises(ValueError, match="frame stack"):
        build_multiframe_deblur_problem(g, images[0])
    with pytest.raises(TypeError, match="Mesh"):
        build_deblur_plan(p, mesh=object())


def test_shift_circulant_is_roll():
    from repro.core.circulant import shift_circulant as ref_shift
    from repro_torch.core.circulant import shift_circulant

    x = torch.arange(8.0)
    for s in (0, 1, 3, -2, 11):
        S = shift_circulant(8, s, device="cpu")
        np.testing.assert_allclose(S.matvec(x).numpy(), torch.roll(x, s).numpy(), atol=1e-6)
        # the adjoint is the inverse shift (S is a permutation)
        np.testing.assert_allclose(S.rmatvec(x).numpy(), torch.roll(x, -s).numpy(), atol=1e-6)
        np.testing.assert_array_equal(S.col.numpy(), np.asarray(ref_shift(8, s).col))
        assert rel(S.spec, ref_shift(8, s).spec) <= 1e-6
    with pytest.raises(ValueError, match="n"):
        shift_circulant(0, 1, device="cpu")
