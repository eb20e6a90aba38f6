"""The port's spectral helpers, circulant algebra and PSFs against the reference.

Inputs are built by ``repro`` (or numpy from a seed) and handed to
``repro_torch`` as numpy arrays through ``repro_torch.interop``.

Tolerance: 1e-5 relative to the largest reference magnitude — both sides are
fp32 pocketfft-class FFTs on the CPU, the reference's own contract.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import circulant as rc
from repro.ops import spectral as rs
from repro_torch import interop
from repro_torch.core import circulant as tc
from repro_torch.ops import spectral as ts

# the packages export a function of the same name, so load the modules by path
rst = importlib.import_module("repro.core.soft_threshold")
tst = importlib.import_module("repro_torch.core.soft_threshold")

NS = (255, 256, 1024)
REL = 1e-5


def close(got, want, rel=REL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rel, f"norm-relative error {err:.3e} > {rel:.0e}"


def t(a):
    return torch.from_numpy(np.array(a))


def _ref_partial(n, seed=0):
    return rc.partial_gaussian_circulant(jax.random.PRNGKey(seed), n, n // 2)


def _port(op):
    return interop.partial_circulant_from_numpy(
        np.asarray(op.circ.col), np.asarray(op.circ.spec), np.asarray(op.omega), device="cpu"
    )


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("batch", [(), (3,)])
def test_spectral_helpers_match_reference(n, batch):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(batch + (n,)).astype(np.float32)
    col = rng.standard_normal(n).astype(np.float32)
    spec_r = rs.rfft(jnp.asarray(col), n)
    close(ts.rfft(t(x), n), rs.rfft(jnp.asarray(x), n))
    close(ts.irfft(ts.rfft(t(x), n), n), rs.irfft(rs.rfft(jnp.asarray(x), n), n))
    close(ts.apply_spectrum(t(spec_r), t(x), n), rs.apply_spectrum(spec_r, jnp.asarray(x), n))
    close(ts.gram_inverse_spectrum(t(spec_r), 0.01, 0.1),
          rs.gram_inverse_spectrum(spec_r, 0.01, 0.1))


@pytest.mark.parametrize("n", NS)
def test_circulant_algebra_matches_reference(n):
    rng = np.random.default_rng(n + 1)
    row = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((2, n)).astype(np.float32)
    ref = rc.Circulant.from_first_row(jnp.asarray(row))
    port = tc.Circulant.from_first_row(t(row))
    other_ref = rc.moving_average_blur(n, 3)
    other = tc.moving_average_blur(n, 3, device="cpu")
    close(port.col, ref.col)
    close(port.spec, ref.spec)
    close(port.first_row, ref.first_row)
    close(port.operator_norm(), ref.operator_norm())
    close(port.matvec(t(x)), ref.matvec(jnp.asarray(x)))
    close(port.rmatvec(t(x)), ref.rmatvec(jnp.asarray(x)))
    for name in ("gram", "transpose"):
        close(getattr(port, name)().col, getattr(ref, name)().col)
    close(port.compose(other).spec, ref.compose(other_ref).spec)
    close(port.compose(other).col, ref.compose(other_ref).col)
    close(port.add_scaled_identity(0.5, 2.0).col, ref.add_scaled_identity(0.5, 2.0).col)
    close(port.gram_inverse_spectrum(0.01, 0.1), ref.gram_inverse_spectrum(0.01, 0.1))
    if n <= 256:
        close(port.to_dense(), ref.to_dense())
    well_posed_ref = ref.add_scaled_identity(1.0, 50.0)  # keep the inverse conditioned
    well_posed = port.add_scaled_identity(1.0, 50.0)
    close(well_posed.inverse().col, well_posed_ref.inverse().col, rel=1e-4)
    spec_rt = tc.Circulant.from_spectrum(port.spec, n)
    close(spec_rt.col, rc.Circulant.from_spectrum(ref.spec, n).col)


def test_compose_rejects_size_mismatch():
    a = tc.moving_average_blur(8, 2, device="cpu")
    b = tc.moving_average_blur(16, 2, device="cpu")
    with pytest.raises(ValueError, match="different sizes"):
        a.compose(b)
    with pytest.raises(ValueError, match="different signal lengths"):
        tc.compose_sensing_blur(a, b)


@pytest.mark.parametrize("n", NS)
def test_partial_circulant_matches_reference(n):
    ref = _ref_partial(n)
    port = _port(ref)
    rng = np.random.default_rng(n + 2)
    x = rng.standard_normal((3, n)).astype(np.float32)
    y = rng.standard_normal((3, n // 2)).astype(np.float32)
    assert port.shape == ref.shape and port.omega.dtype == torch.int64
    close(port.matvec(t(x)), ref.matvec(jnp.asarray(x)))
    close(port.rmatvec(t(y)), ref.rmatvec(jnp.asarray(y)))
    close(port.project_back(t(y)), ref.project_back(jnp.asarray(y)))
    close(port.operator_norm_bound(), ref.operator_norm_bound())
    close(port.gram_inverse_spectrum(0.01, 0.01), ref.gram_inverse_spectrum(0.01, 0.01))
    if n <= 256:
        close(port.to_dense(), ref.to_dense())


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize(
    "kind,width", [("moving_average_blur", 5), ("gaussian_blur", 1.5), ("airy_blur", 2.0)]
)
def test_psf_families_match_reference(n, kind, width):
    ref = getattr(rc, kind)(n, width)
    port = getattr(tc, kind)(n, width, device="cpu")
    close(port.col, ref.col)
    close(port.spec, ref.spec)
    assert abs(float(port.col.sum()) - 1.0) < 1e-5  # every PSF keeps flux


@pytest.mark.parametrize("kind", ["moving_average_blur", "gaussian_blur", "airy_blur"])
@pytest.mark.parametrize("width", [0, 17])
def test_psf_builders_validate_width(kind, width):
    with pytest.raises(ValueError):
        getattr(tc, kind)(16, width, device="cpu")


def test_bessel_j1_matches_reference():
    u = np.linspace(0.0, 20.0, 101, dtype=np.float32)
    close(tc._bessel_j1(t(u)), rc._bessel_j1(jnp.asarray(u)))


@pytest.mark.parametrize("n", NS)
def test_compose_sensing_blur_matches_reference(n):
    ref = rc.compose_sensing_blur(
        rc.romberg_circulant(jax.random.PRNGKey(4), n), rc.gaussian_blur(n, 1.0)
    )
    sense_ref = rc.romberg_circulant(jax.random.PRNGKey(4), n)
    sense = interop.circulant_from_numpy(
        np.asarray(sense_ref.col), np.asarray(sense_ref.spec), device="cpu"
    )
    port = tc.compose_sensing_blur(sense, tc.gaussian_blur(n, 1.0, device="cpu"))
    close(port.spec, ref.spec)
    close(port.col, ref.col)


@pytest.mark.parametrize("n", NS)
def test_random_factories_are_seeded_and_well_formed(n):
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (tc.partial_gaussian_circulant(g, n, n // 2, normalize=True, device="cpu"),
                tc.romberg_circulant(g, n, device="cpu"))

    (pg, rom), (pg2, _) = draw(7), draw(7)
    assert torch.equal(pg.circ.col, pg2.circ.col) and torch.equal(pg.omega, pg2.omega)
    om = pg.omega
    assert om.dtype == torch.int64 and om.shape == (n // 2,)
    assert bool((om[1:] > om[:-1]).all()) and 0 <= int(om[0]) and int(om[-1]) < n
    assert abs(float(pg.circ.operator_norm()) - 1.0) < 1e-5  # normalize=True
    np.testing.assert_allclose(rom.spec.abs().numpy(), 1.0, atol=1e-5)  # orthogonal C


@pytest.mark.parametrize("gamma", [0.0, 0.3])
def test_soft_threshold_matches_reference(gamma):
    x = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    x[:8] = 0.0
    x[8:16] = gamma
    close(tst.soft_threshold(t(x), gamma), rst.soft_threshold(jnp.asarray(x), gamma))
    nu = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    close(tst.admm_z_update(t(x), t(nu), gamma),
          rst.admm_z_update(jnp.asarray(x), jnp.asarray(nu), gamma))
    close(tst.ista_update(t(x), t(nu), gamma),
          rst.ista_update(jnp.asarray(x), jnp.asarray(nu), gamma))
    assert float(tst.soft_threshold(torch.zeros(3), 0.0).abs().sum()) == 0.0  # sign(0) == 0
