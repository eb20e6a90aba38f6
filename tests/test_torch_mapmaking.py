"""Herschel-style map-making on the port (``repro_torch.core.mapmaking``).

Mirrors ``tests/test_mapmaking.py``'s eight cases on the reference's own
problem (sky key 7, problem key 11, 16 x 16, the 2x2 dither), carried
across by ``repro_torch.interop.mapmaking_problem_from_numpy``.  In place of
the reference's golden PSNR band, the TV and l1 maps' PSNRs are held
against the reference's computed PSNRs for the same inputs (0.01 dB) and
the maps within 1e-5; TV must still beat l1 by the reference's own 15 dB.
The planned solve runs on a 2-rank gloo mesh (rfft) and is held against the
local one at 1e-5, and ``extended_emission`` paints the reference's draws
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_programs import mapmaking_mesh_program

from repro.core.mapmaking import build_mapmaking_plan as ref_plan
from repro.core.mapmaking import build_mapmaking_problem as ref_build
from repro.core.mapmaking import solve_mapmaking as ref_solve
from repro.data.synthetic import extended_emission as ref_emission
from repro_torch import interop
from repro_torch.core.mapmaking import (
    build_mapmaking_plan,
    build_mapmaking_problem,
    coadd,
    frame_operator,
    mapmaking_metrics,
    solve_mapmaking,
)
from repro_torch.data.synthetic import _paint_disks, extended_emission
from repro_torch.dist.compat import spawn_fake_devices

SIZE = 16
SHIFTS = [0, 1, SIZE, SIZE + 1]  # 2x2 dither pattern on the raster
ITERS = 600


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _arrays(ref) -> dict:
    a, d = np.asarray, ref.deblur
    return dict(col=a(d.op.circ.col), spec=a(d.op.circ.spec), omega=a(d.op.omega),
                blur_col=a(d.blur.col), blur_spec=a(d.blur.spec), y=a(d.y), image=a(d.image),
                sky=a(ref.sky), shifts=ref.shifts)


@pytest.fixture(scope="module")
def ref():
    sky = ref_emission(jax.random.PRNGKey(7), SIZE, SIZE, n_sources=3)
    return ref_build(jax.random.PRNGKey(11), sky, SHIFTS, blur_order=1.0, subsample=0.5,
                     sensing="romberg", blur_kind="gaussian")


@pytest.fixture(scope="module")
def problem(ref):
    return interop.mapmaking_problem_from_numpy(**_arrays(ref), device="cpu")


@pytest.fixture(scope="module")
def solves(ref, problem):
    """The TV and l1 600-iteration solves, on both sides."""
    out = {}
    for prior, prox in (("tv", "tv"), ("l1", None)):
        out["ref", prior] = ref_solve(ref, plan=ref_plan(ref, prox=prox), iters=ITERS,
                                      alpha=1e-4)
        out["port", prior] = solve_mapmaking(
            problem, plan=build_mapmaking_plan(problem, prox=prox), iters=ITERS, alpha=1e-4)
    return out


def test_build_validation():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="sky map"):
        build_mapmaking_problem(g, torch.zeros(2, 8, 8), [0])
    with pytest.raises(ValueError, match="offset"):
        build_mapmaking_problem(g, torch.zeros(8, 8), [])


def test_build_runs_from_a_generator():
    g = torch.Generator().manual_seed(3)
    sky = extended_emission(g, 8, 8, device="cpu")
    p = build_mapmaking_problem(g, sky, [0, 1])
    assert p.deblur.y.shape == (2, 32) and p.shifts == (0, 1)
    assert torch.equal(p.deblur.image[1].reshape(-1), torch.roll(sky.reshape(-1), 1))


def test_frames_are_shifted_skies(problem):
    flat = problem.sky.reshape(-1)
    for f, s in enumerate(problem.shifts):
        assert torch.equal(problem.deblur.image[f].reshape(-1), torch.roll(flat, s))
    assert problem.deblur.y.shape == (len(SHIFTS), problem.deblur.op.m)


def test_frame_operator_factored_view(problem, ref):
    """A_f = P (C B S_f) composed through shift circulants equals the shared
    operator on the shifted sky, and the reference's own factored view."""
    from repro.core.mapmaking import frame_operator as ref_frame_operator

    flat = problem.sky.reshape(-1)
    for f, s in enumerate(problem.shifts):
        a = frame_operator(problem, f).matvec(flat)
        b = problem.deblur.op.matvec(torch.roll(flat, s))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        np.testing.assert_allclose(problem.deblur.y[f].numpy(), b.numpy(), atol=1e-5)
        want = np.asarray(ref_frame_operator(ref, f).matvec(ref.sky.reshape(-1)))
        assert _rel(a.numpy(), want) <= 1e-5


def test_coadd_unshifts_and_averages(problem, ref):
    n = SIZE * SIZE
    z_true = problem.deblur.image.reshape(len(SHIFTS), n)
    np.testing.assert_allclose(coadd(problem, z_true).numpy(), problem.sky.numpy(), atol=1e-6)
    m = mapmaking_metrics(problem, z_true)
    assert float(m["psnr_db"]) > 100.0
    assert coadd(problem, torch.stack([z_true, z_true])).shape == (2, SIZE, SIZE)
    from repro.core.mapmaking import mapmaking_metrics as ref_metrics

    z_noisy = z_true + 0.01 * torch.from_numpy(
        np.array(jax.random.normal(jax.random.PRNGKey(4), (len(SHIFTS), n))))
    m, m_ref = mapmaking_metrics(problem, z_noisy), ref_metrics(ref, jnp.asarray(z_noisy.numpy()))
    assert sorted(m) == sorted(m_ref)
    for key in m:
        assert _rel(m[key].numpy(), m_ref[key]) <= 1e-6, key


def test_default_plan_is_tv(problem):
    pl = build_mapmaking_plan(problem)
    assert "prox=tv[16x16" in pl.config.describe()
    assert "prox=" not in build_mapmaking_plan(problem, prox=None).config.describe()


def test_mapmaking_psnr_matches_reference(solves):
    """The reference's golden pin, held against the reference's computed
    output instead: both maps and their PSNRs agree, and the TV map beats
    the l1 map by the reference's own margin."""
    for prior in ("tv", "l1"):
        (z, m), (z_ref, m_ref) = solves["port", prior], solves["ref", prior]
        assert abs(float(m["psnr_db"]) - float(m_ref["psnr_db"])) <= 0.01, prior
        assert _rel(m["map"].numpy(), m_ref["map"]) <= 1e-5, prior
        assert _rel(z.numpy(), z_ref) <= 1e-5, prior
    assert float(solves["port", "tv"][1]["psnr_db"]) > float(
        solves["port", "l1"][1]["psnr_db"]) + 15.0


def test_mapmaking_planned_matches_local(ref, solves):
    """The TV stack through a 2-rank mesh (rfft, the hybrid step) matches
    the local solve at 1e-5."""
    z_d, psnr_d, tag = spawn_fake_devices(2, mapmaking_mesh_program, _arrays(ref), ITERS)[0]
    z_l, m_l = solves["port", "tv"]
    assert "prox=tv[16x16" in tag and "rfft=on" in tag
    assert _rel(z_d.numpy(), z_l.numpy()) <= 1e-5
    assert abs(float(psnr_d) - float(m_l["psnr_db"])) <= 0.01


def test_extended_emission_statistics():
    sky = extended_emission(torch.Generator().manual_seed(7), 32, 32, n_sources=3,
                            device="cpu")
    assert float(sky.min()) > 0.0 and float(sky.max()) <= 1.0
    edges = ((torch.roll(sky, -1, 0) - sky).abs() > 1e-6).float().mean()
    assert float(edges) < 0.5
    assert float((sky > 0).float().mean()) == 1.0


@pytest.mark.parametrize("key,h,w,n_sources", [(7, 16, 16, 3), (7, 32, 32, 3),
                                               (0, 64, 48, 5), (3, 100, 100, 8)])
def test_extended_emission_paints_the_reference_draws_bit_for_bit(key, h, w, n_sources):
    k = jax.random.PRNGKey(key)
    want = np.asarray(ref_emission(k, h, w, n_sources=n_sources))
    draws = torch.from_numpy(np.array(jax.random.uniform(k, (n_sources, 4), jnp.float32)))
    np.testing.assert_array_equal(_paint_disks(draws, h, w, 0.05).numpy(), want)
