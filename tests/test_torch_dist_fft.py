"""The port's distributed four-step transforms, against the reference's spectra.

Mirrors ``tests/test_dist_equiv.py`` and ``tests/dist_progs/fft_prog.py``
as gloo ranks in child processes (``spawn_fake_devices``, the CPU).  The
reference computes the flat spectra and operator products in this process
(JAX on the CPU), and the ranks get them through numpy.  Every case of a
world size runs in one spawn, shared by the tests below.

N1 x N2 = 32 x 16: at 4 ranks the half spectrum's nf = 9 columns pad to 12.
The spectrum is compared with ``jnp.fft.fft`` of the flat signal through
``freq_flat``: a wrong chunk order in the all-to-all permutes forward and
inverse alike, so round trips and matvecs would still pass, and only the
spectrum itself shows it.  Tolerances: 1e-5 relative to the largest
magnitude (fp32 transforms of 512 points), 1e-6 between overlap factors
(the same operations, reordered).
"""

import numpy as np
import pytest
import torch

from repro_torch.dist import fft as D
from repro_torch.dist.compat import gather_cat, make_mesh, spawn_fake_devices
from repro_torch.ops.spectral import spectrum_layout_2d

N1, N2 = 32, 16
N = N1 * N2
B = 3
RANKS = (2, 4)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rank_program(x, col, spec_h):
    """Every transform case on this rank; rank 0 returns the gathered results."""
    from repro_torch.dist.recovery import make_dist_spectrum
    from repro_torch.ops.plan import WIRE_ERROR_BOUND

    mesh = make_mesh((torch.distributed.get_world_size(),), ("model",))
    cols = lambda F2: gather_cat(F2, mesh.group("model"), dim=-1)
    rows = lambda a: D.unlayout_2d(D.gather_rows(a, mesh))
    x = torch.from_numpy(x)
    a = D.row_block(D.layout_2d(x, N1, N2), mesh)
    out = {"bound": WIRE_ERROR_BOUND}
    for ov in (1, 2, 3):
        fft2d, ifft2d = D.make_distributed_fft(mesh, overlap=ov)
        rfft2d, irfft2d = D.make_distributed_rfft(mesh, N2, overlap=ov)
        F2, H = fft2d(a.to(torch.complex64)), rfft2d(a)
        out[f"fft{ov}"] = D.freq_flat(cols(F2))
        out[f"half{ov}"] = D.freq_flat(D.half_to_full(cols(H), N2))
        out[f"ifft{ov}"] = rows(ifft2d(F2).real)
        out[f"irfft{ov}"] = rows(irfft2d(H))
    full = D.col_block(spectrum_layout_2d(torch.from_numpy(spec_h), N1, N2), mesh)
    half = D.col_block(spectrum_layout_2d(torch.from_numpy(spec_h), N1, N2, rfft=True,
                                          p=mesh.size("model")), mesh)
    col_rows = D.row_block(D.layout_2d(torch.from_numpy(col), N1, N2), mesh)
    out["spec_full"] = float((make_dist_spectrum(mesh)(col_rows) - full).abs().max())
    out["spec_half"] = float((make_dist_spectrum(mesh, rfft=True)(col_rows) - half).abs().max())
    for rfft, spec in ((False, full), (True, half)):
        for wire in ("fp32", "bf16", "fp16"):
            mv = D.make_distributed_matvec(mesh, rfft=rfft, overlap=2, wire_dtype=wire)
            for transpose in (False, True):
                out[f"mv{int(rfft)}{int(transpose)}{wire}"] = rows(mv(spec, a, transpose))
    return out if torch.distributed.get_rank() == 0 else None


@pytest.fixture(scope="module")
def ref():
    """The reference's input and answers (JAX, this process only)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core.circulant import gaussian_circulant

    x = np.random.default_rng(0).standard_normal((B, N)).astype(np.float32)
    C = gaussian_circulant(jax.random.PRNGKey(1), N, normalize=True)
    return dict(
        x=x, col=np.asarray(C.col), spec_h=np.asarray(C.spec),
        fft=np.asarray(jnp.fft.fft(jnp.asarray(x).astype(jnp.complex64))),
        mv=np.asarray(C.matvec(jnp.asarray(x))), rmv=np.asarray(C.rmatvec(jnp.asarray(x))),
    )


@pytest.fixture(scope="module")
def runs(ref):
    return {p: spawn_fake_devices(p, _rank_program, ref["x"], ref["col"], ref["spec_h"])[0]
            for p in RANKS}


@pytest.mark.parametrize("p", RANKS)
def test_four_step_spectrum_equals_flat_fft(p, runs, ref):
    assert _rel(runs[p]["fft1"], ref["fft"]) <= 1e-5


@pytest.mark.parametrize("p", RANKS)
def test_half_spectrum_unfolds_to_flat_fft(p, runs, ref):
    assert _rel(runs[p]["half1"], ref["fft"]) <= 1e-5


@pytest.mark.parametrize("p", RANKS)
def test_round_trips_are_the_identity(p, runs, ref):
    assert _rel(runs[p]["ifft1"], ref["x"]) <= 1e-5
    assert _rel(runs[p]["irfft1"], ref["x"]) <= 1e-5


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("overlap", [2, 3])
def test_overlap_agrees_with_one_exchange(p, overlap, runs):
    r = runs[p]
    for kind in ("fft", "half", "ifft", "irfft"):
        assert _rel(r[f"{kind}{overlap}"], r[f"{kind}1"]) <= 1e-6, kind


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("rfft", [False, True])
def test_matvec_matches_reference_operator(p, rfft, runs, ref):
    r = runs[p]
    assert _rel(r[f"mv{int(rfft)}0fp32"], ref["mv"]) <= 1e-5
    assert _rel(r[f"mv{int(rfft)}1fp32"], ref["rmv"]) <= 1e-5


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("wire", ["bf16", "fp16"])
def test_demoted_wire_matvec_error_is_within_the_guard_bound(p, wire, runs):
    r = runs[p]
    for rfft in (0, 1):
        for transpose in (0, 1):
            got, want = r[f"mv{rfft}{transpose}{wire}"], r[f"mv{rfft}{transpose}fp32"]
            err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            assert 0.0 < err <= r["bound"], (rfft, transpose, err)


@pytest.mark.parametrize("p", RANKS)
def test_dist_spectrum_equals_the_stored_spectrum_laid_out(p, runs):
    # the plan lays out the operator's stored spectrum; a transform of the
    # first column must give the same blocks
    assert runs[p]["spec_full"] <= 1e-4 and runs[p]["spec_half"] <= 1e-4


def test_layout_helpers_match_reference(ref):
    import jax.numpy as jnp

    from repro.dist import fft as R

    x = ref["x"]
    a = D.layout_2d(torch.from_numpy(x), N1, N2)
    np.testing.assert_array_equal(a.numpy(), np.asarray(R.layout_2d(jnp.asarray(x), N1, N2)))
    np.testing.assert_array_equal(D.unlayout_2d(a).numpy(), x)
    np.testing.assert_array_equal(D.freq_flat(a).numpy(),
                                  np.asarray(R.freq_flat(R.layout_2d(jnp.asarray(x), N1, N2))))
    for extent in (1, 7, 8, 257):
        for overlap in (1, 2, 3, 4, 300):
            assert D._chunk_grid(extent, overlap) == R._chunk_grid(extent, overlap)


def test_twiddle_exponent_is_exact_past_int32_and_float32():
    """The exponent j1*k2 is an int64 reduced mod n before the float32 divide:
    at n = 2^32 an int32 product would overflow and a float32 one round."""
    n = 2 ** 32
    j1 = torch.tensor([2 ** 31 - 1, 65537, 3], dtype=torch.int64)
    k2 = torch.tensor([2 ** 20 + 7, 2 ** 16 + 1, 5], dtype=torch.int64)
    got = D._phase(j1 * k2, n)
    num = (j1.numpy().astype(object) * k2.numpy().astype(object)) % n
    want = np.exp(-2j * np.pi * (np.array([float(v) for v in num]) / n))
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_twiddled_first_stage_is_contiguous_whatever_the_fft_layout():
    """The inverse transforms' first stage feeds the wire pack, which takes
    contiguous payloads only; an FFT over a leading axis may come back in a
    transposed layout (cuFFT does), and the twiddle product lays it out."""
    b = torch.randn(3, 8, 6, dtype=torch.complex64).transpose(-1, -2)  # strided (3, 6, 8)
    tw = D._twiddle(0, 6, 0, 8, 48, True, b.device)
    out = D._twiddled(b, tw)
    assert out.is_contiguous() and torch.equal(out, b * tw)
