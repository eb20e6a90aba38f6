"""Each kernel's plain version against the reference's oracle and Pallas kernel.

The reference's Pallas kernels run in interpret mode on the CPU, as
``tests/test_kernels.py`` runs them.  The port's wrappers, given CPU
tensors, run their plain versions and leave their launch counters at 0.
The hand-written kernels themselves run only on a CUDA card: the ``gpu``
test at the end holds them against the plain versions there and skips here.

Tolerance: 1e-5 relative to the largest reference magnitude (fp32 on both
sides; the direct matvec sums up to 640 products, still far inside it);
the soft-threshold and banded-blur kernels are held at the reference's own
absolute tolerances (``tests/test_kernels.py``: 1e-6 and 1e-5).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core.circulant import moving_average_blur
from repro_torch.kernels.banded_conv.ops import blur_apply
from repro_torch.kernels.banded_conv.ref import banded_circulant_matvec_ref
from repro_torch.kernels.circulant_matvec import ops as matvec_ops
from repro_torch.kernels.circulant_matvec.ref import circulant_matvec_fft, circulant_matvec_ref
from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
from repro_torch.kernels.cpadmm_tail.ref import cpadmm_tail_ref
from repro_torch.kernels.soft_threshold import kernel as threshold_kernel
from repro_torch.kernels.soft_threshold.ops import fused_admm_update, fused_ista_update
from repro_torch.kernels.soft_threshold.ref import (
    admm_threshold_dual_update_ref,
    ista_step_update_ref,
    ista_threshold_update_ref,
)
from repro_torch.kernels.spectral_pointwise.ops import spectral_update
from repro_torch.kernels.spectral_pointwise.ref import cpadmm_spectral_update_ref

REL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The reference's kernels and oracles.  Loaded here rather than at the top
    so the ``gpu`` test also runs on a card machine that has no JAX."""
    pytest.importorskip("jax")
    from repro.kernels.banded_conv import ops as blur_ops
    from repro.kernels.banded_conv import ref as blur_ref
    from repro.kernels.circulant_matvec import kernel as mv_kernel
    from repro.kernels.circulant_matvec import ops as mv_ops
    from repro.kernels.circulant_matvec import ref as mv_ref
    from repro.kernels.cpadmm_tail import ops as tail_ops
    from repro.kernels.cpadmm_tail import ref as tail_ref
    from repro.kernels.soft_threshold import ops as st_ops
    from repro.kernels.soft_threshold import ref as st_ref
    from repro.kernels.spectral_pointwise import ops as spec_ops
    from repro.kernels.spectral_pointwise import ref as spec_ref

    return types.SimpleNamespace(
        jnp=pytest.importorskip("jax.numpy"),
        matvec_pallas=mv_kernel.circulant_matvec_pallas,
        FFT_CROSSOVER=mv_ops.FFT_CROSSOVER,
        matvec_dense=mv_ref.circulant_matvec_ref,
        fused_tail=tail_ops.fused_cpadmm_tail,
        tail=tail_ref.cpadmm_tail_ref,
        spectral=spec_ops.spectral_update,
        spectral_ref=spec_ref.cpadmm_spectral_update_ref,
        ista_update=st_ops.fused_ista_update,
        ista_update_ref=st_ref.ista_threshold_update_ref,
        admm_update=st_ops.fused_admm_update,
        admm_update_ref=st_ref.admm_threshold_dual_update_ref,
        blur_apply=blur_ops.blur_apply,
        blur_ref=blur_ref.banded_circulant_matvec_ref,
    )


def close(got, want, rel=REL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)
    assert err <= rel, f"norm-relative error {err:.3e} > {rel:.0e}"


def t(a):
    return torch.from_numpy(np.array(a))


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture
def counters():
    """Zero every wrapper's launch counter; hand back a reader."""
    wrappers = (spectral_update, fused_cpadmm_tail, matvec_ops.circulant_matvec_direct,
                fused_ista_update, fused_admm_update, blur_apply)
    for w in wrappers:
        w.launches = 0
    return lambda: [w.launches for w in wrappers]


# ---------------------------------------------------------------------------
# spectral_pointwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nf", [128, 129, 513, 1000])  # n = 255, 256, 1024; ragged
@pytest.mark.parametrize("batch", [(), (3,)])
def test_spectral_update_matches_reference(nf, batch, counters, ref):
    rng = np.random.default_rng(nf)
    c, vm, zn = _complex(rng, nf), _complex(rng, batch + (nf,)), _complex(rng, batch + (nf,))
    b = rng.uniform(0.5, 2.0, nf).astype(np.float32)
    got = spectral_update(t(c), t(b), t(vm), t(zn), 0.01, 0.02)
    args = tuple(ref.jnp.asarray(a) for a in (c, b, vm, zn))
    close(got, ref.spectral(*args, 0.01, 0.02, interpret=True))  # the Pallas kernel
    close(got, ref.spectral_ref(*args, 0.01, 0.02))
    close(cpadmm_spectral_update_ref(t(c), t(b), t(vm), t(zn), 0.01, 0.02), got, rel=0)
    assert counters() == [0] * 6


def test_spectral_update_rejects_bad_operands():
    c = torch.zeros(9, dtype=torch.complex64)
    with pytest.raises(ValueError, match="real spectrum"):
        spectral_update(c, c, c, c, 0.1, 0.1)
    with pytest.raises(ValueError, match="shapes"):
        spectral_update(c, torch.zeros(9), torch.zeros(2, 8, dtype=torch.complex64),
                        torch.zeros(2, 8, dtype=torch.complex64), 0.1, 0.1)


# ---------------------------------------------------------------------------
# cpadmm_tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1000, 4096])
@pytest.mark.parametrize("batch,pty_batched", [((), False), ((3,), False), ((3,), True)])
def test_cpadmm_tail_matches_reference(L, batch, pty_batched, counters, ref):
    rng = np.random.default_rng(L)
    d = rng.uniform(0.5, 2.0, L).astype(np.float32)
    pty = rng.standard_normal(batch + (L,) if pty_batched else (L,)).astype(np.float32)
    x, cx, mu, nu = (rng.standard_normal(batch + (L,)).astype(np.float32) for _ in range(4))
    x[..., :16] = 0.0  # exercise sign(0) and the threshold edge
    nu[..., :16] = 0.0
    scal = (0.01, 0.3, 1.0, 0.9)
    got = fused_cpadmm_tail(t(x), t(cx), t(d), t(pty), t(mu), t(nu), *scal)
    args = tuple(ref.jnp.asarray(a) for a in (x, cx, d, pty, mu, nu))
    want_kernel = ref.fused_tail(*args, *scal, interpret=True)  # the Pallas kernel
    want_ref = ref.tail(*args, *scal)
    plain = cpadmm_tail_ref(t(x), t(cx), t(d), t(pty), t(mu), t(nu), *scal)
    for g, wk, wr, p in zip(got, want_kernel, want_ref, plain):
        close(g, wk)
        close(g, wr)
        close(p, g, rel=0)
    assert counters() == [0] * 6


def test_cpadmm_tail_rejects_bad_shapes():
    a = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="shapes"):
        fused_cpadmm_tail(a, a, torch.zeros(8), torch.zeros(3, 8), a, a, 0.1, 0.1, 1.0, 1.0)


# ---------------------------------------------------------------------------
# circulant_matvec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [128, 256, 640])
@pytest.mark.parametrize("transpose", [False, True])
def test_circulant_matvec_matches_reference(n, transpose, counters, ref):
    rng = np.random.default_rng(n)
    col = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((3, n)).astype(np.float32)
    got = matvec_ops.circulant_matvec_direct(t(col), t(x), transpose=transpose)
    for row in range(3):  # the reference kernel takes 1-D x only
        col_j, x_j = ref.jnp.asarray(col), ref.jnp.asarray(x[row])
        close(got[row], ref.matvec_pallas(col_j, x_j, transpose=transpose, block=128))
        close(got[row], ref.matvec_dense(col_j, x_j, transpose=transpose))
    close(circulant_matvec_fft(t(col), t(x), transpose=transpose), got)
    close(circulant_matvec_ref(t(col), t(x[0]), transpose=transpose), got[0])
    assert counters() == [0] * 6


CROSSOVER = matvec_ops.FFT_CROSSOVER


@pytest.mark.parametrize("n,direct", [(256, True), (1000, False), (CROSSOVER - 128, True),
                                      (CROSSOVER, False), (1 << 15, False)])
def test_circulant_matvec_dispatch(n, direct, monkeypatch, ref):
    """Direct below FFT_CROSSOVER with n % 128 == 0, the FFT path otherwise.
    The port's crossover is its own, chosen on the H100 (2^13; the
    reference's TPU-era 2^15 sends n = 2^13 and 2^14 down the slower branch
    there)."""
    assert CROSSOVER == 1 << 13 and ref.FFT_CROSSOVER == 1 << 15
    calls = []
    direct_fn = matvec_ops.circulant_matvec_direct

    def spy(col, x, *, transpose=False):
        calls.append(n)
        # on the CPU the direct wrapper is the dense plain version, O(n^2)
        # memory: past 4096 the FFT path stands in for its value
        return (direct_fn if n <= 4096 else circulant_matvec_fft)(col, x, transpose=transpose)

    monkeypatch.setattr(matvec_ops, "circulant_matvec_direct", spy)
    col = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n).astype(np.float32))
    y = matvec_ops.circulant_matvec(col, x)
    assert bool(calls) == direct
    close(y, circulant_matvec_fft(col, x))


def test_circulant_matvec_rejects_bad_shapes():
    with pytest.raises(ValueError, match=r"\(n,\)"):
        matvec_ops.circulant_matvec_direct(torch.zeros(128), torch.zeros(2, 256))


# ---------------------------------------------------------------------------
# soft_threshold (the fused CPISTA update and the ADMM threshold + dual)
# ---------------------------------------------------------------------------

GAMMAS = [0.0, 1e-3, 0.5]
THRESHOLD_NS = [1024, 4096, 1000, 7]  # block multiples, ragged, shorter than a block


def _threshold_operands(n, batch=()):
    rng = np.random.default_rng(n)
    x, other = (rng.standard_normal(batch + (n,)).astype(np.float32) for _ in range(2))
    x[..., :3] = 0.0  # exercise sign(0) and the threshold edge
    other[..., :3] = 0.0
    return x, other


@pytest.mark.parametrize("n", THRESHOLD_NS)
@pytest.mark.parametrize("gamma", GAMMAS)
def test_fused_ista_update_matches_reference(n, gamma, counters, ref):
    x, delta = _threshold_operands(n)
    got = fused_ista_update(t(x), t(delta), gamma).numpy()
    xj, dj = ref.jnp.asarray(x), ref.jnp.asarray(delta)
    np.testing.assert_allclose(got, np.asarray(ref.ista_update(xj, dj, gamma, interpret=True)),
                               atol=1e-6)  # the Pallas kernel
    np.testing.assert_allclose(got, np.asarray(ref.ista_update_ref(xj, dj, gamma)), atol=1e-6)
    assert counters() == [0] * 6


@pytest.mark.parametrize("n", THRESHOLD_NS)
@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("tau2", [0.1, 1.0, 1.6])
def test_fused_admm_update_matches_reference(n, gamma, tau2, counters, ref):
    x, nu = _threshold_operands(n)
    z, nu_new = fused_admm_update(t(x), t(nu), gamma, tau2)
    xj, nj = ref.jnp.asarray(x), ref.jnp.asarray(nu)
    for want in (ref.admm_update(xj, nj, gamma, tau2, interpret=True),  # the Pallas kernel
                 ref.admm_update_ref(xj, nj, gamma, tau2)):
        np.testing.assert_allclose(z.numpy(), np.asarray(want[0]), atol=1e-6)
        np.testing.assert_allclose(nu_new.numpy(), np.asarray(want[1]), atol=1e-6)
    assert counters() == [0] * 6


@pytest.mark.parametrize("n", [1000, 4096])
def test_soft_threshold_batched_rows_match_reference(n, counters, ref):
    """The port takes a leading batch (the reference's kernels are 1-D), and
    a threshold given as a one-element tensor, as CPISTA computes it."""
    x, other = _threshold_operands(n, batch=(3,))
    gamma, tau2 = 0.5, 1.6
    got = fused_ista_update(t(x), t(other), torch.tensor(gamma))
    z, nu_new = fused_admm_update(t(x), t(other), torch.tensor(gamma), tau2)
    for row in range(3):
        xj, oj = ref.jnp.asarray(x[row]), ref.jnp.asarray(other[row])
        np.testing.assert_allclose(got[row].numpy(),
                                   np.asarray(ref.ista_update_ref(xj, oj, gamma)), atol=1e-6)
        want_z, want_nu = ref.admm_update_ref(xj, oj, gamma, tau2)
        np.testing.assert_allclose(z[row].numpy(), np.asarray(want_z), atol=1e-6)
        np.testing.assert_allclose(nu_new[row].numpy(), np.asarray(want_nu), atol=1e-6)
    close(ista_threshold_update_ref(t(x), t(other), gamma), got, rel=0)
    for g, w in zip(admm_threshold_dual_update_ref(t(x), t(other), gamma, tau2), (z, nu_new)):
        close(g, w, rel=0)
    assert counters() == [0] * 6


@pytest.mark.parametrize("n", THRESHOLD_NS)
@pytest.mark.parametrize("tau_kind", ["tensor", "number"])
def test_fused_ista_update_with_tau_matches_reference(n, tau_kind, counters, ref):
    """The folded form eta_{alpha tau}(x + tau grad), CPISTA's whole update,
    against the reference's Pallas kernel given tau * grad and alpha * tau."""
    x, grad = _threshold_operands(n)
    alpha, tau = 0.3, 0.7
    got = fused_ista_update(t(x), t(grad), alpha,
                            tau=torch.tensor(tau) if tau_kind == "tensor" else tau).numpy()
    xj, gj = ref.jnp.asarray(x), ref.jnp.asarray(grad)
    tau32 = ref.jnp.float32(tau)
    want = ref.ista_update(xj, tau32 * gj, ref.jnp.float32(alpha) * tau32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert counters() == [0] * 6


def test_soft_threshold_rejects_bad_operands():
    with pytest.raises(ValueError, match="shapes"):
        fused_ista_update(torch.zeros(2, 8), torch.zeros(8), 0.1)
    with pytest.raises(ValueError, match="shapes"):
        fused_admm_update(torch.zeros(8), torch.zeros(9), 0.1, 1.0)


# ---------------------------------------------------------------------------
# banded_conv (the Sec. 7 blur stencil)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,order", [(1024, 5), (2048, 3), (4096, 17), (1000, 5)])
def test_blur_apply_matches_reference(n, order, counters, ref):
    rng = np.random.default_rng(n + order)
    taps = rng.standard_normal(order).astype(np.float32)
    x = rng.standard_normal((2, n)).astype(np.float32)
    got = blur_apply(t(taps), t(x), order=order).numpy()
    tj = ref.jnp.asarray(taps)
    for row in range(2):  # the reference's kernel takes 1-D x only
        xj = ref.jnp.asarray(x[row])
        np.testing.assert_allclose(got[row], np.asarray(ref.blur_apply(tj, xj, order=order)),
                                   atol=1e-5)
        np.testing.assert_allclose(got[row], np.asarray(ref.blur_ref(tj, xj, order=order)),
                                   atol=1e-5)
    assert counters() == [0] * 6


@pytest.mark.parametrize("n", [1024, 1000])
def test_blur_apply_is_the_moving_average_blur(n, counters):
    """First-row taps [1/L] * L == the order-L moving-average circulant."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((3, n)).astype(np.float32))
    got = blur_apply(torch.full((5,), 1.0 / 5), x, order=5)
    np.testing.assert_allclose(got.numpy(), moving_average_blur(n, 5, device="cpu").matvec(x)
                               .numpy(), atol=1e-5)
    close(banded_circulant_matvec_ref(torch.full((5,), 0.2), x, order=5), got, rel=0)
    assert counters() == [0] * 6


def test_blur_apply_rejects_bad_operands():
    with pytest.raises(ValueError, match="order"):
        blur_apply(torch.ones(3), torch.zeros(2, 16), order=4)
    with pytest.raises(ValueError, match="order"):
        blur_apply(torch.ones(3, 1), torch.zeros(16), order=1)


@pytest.mark.parametrize("kernel", ["spectral_pointwise", "cpadmm_tail", "circulant_matvec",
                                    "soft_threshold", "banded_conv"])
def test_wrappers_raise_on_tensors_they_cannot_launch(kernel, counters):
    """Off the CPU a wrapper launches its kernel or raises: a tensor that is
    neither CPU nor CUDA (here on the meta device) gets an error, never the
    plain version."""
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        if kernel == "spectral_pointwise":
            c = meta(9, dtype=torch.complex64)
            spectral_update(c, meta(9), c, c, 0.1, 0.1)
        elif kernel == "cpadmm_tail":
            a = meta(2, 8)
            fused_cpadmm_tail(a, a, meta(8), meta(8), a, a, 0.1, 0.1, 1.0, 1.0)
        elif kernel == "circulant_matvec":
            matvec_ops.circulant_matvec_direct(meta(128), meta(2, 128))
        elif kernel == "soft_threshold":
            fused_ista_update(meta(2, 7), meta(2, 7), 0.1)
        else:
            blur_apply(meta(5), meta(2, 1000), order=5)
    if kernel == "soft_threshold":
        with pytest.raises(ValueError, match="CUDA tensors"):
            fused_admm_update(meta(2, 7), meta(2, 7), 0.1, 1.0)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fused_ista_update(meta(2, 7), meta(2, 7), 0.1, tau=torch.tensor(0.5))
    assert counters() == [0] * 6


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version (skips without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card(cuda_device, counters):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    rnd = lambda *s, dtype=torch.float32: torch.randn(*s, generator=g, device=cuda_device,
                                                      dtype=dtype)
    nf, L, n, B = 1025, 4096, 1024, 3
    c, vm, zn = (rnd(*s, dtype=torch.complex64) for s in ((nf,), (B, nf), (B, nf)))
    b = torch.rand(nf, generator=g, device=cuda_device)
    close(spectral_update(c, b, vm, zn, 0.01, 0.02),
          cpadmm_spectral_update_ref(c, b, vm, zn, 0.01, 0.02).cpu(), rel=1e-6)
    d = torch.rand(L, generator=g, device=cuda_device)
    x, cx, mu, nu = (rnd(B, L) for _ in range(4))
    for pty in (rnd(L), rnd(B, L)):
        args = (x, cx, d, pty, mu, nu, 0.01, 0.3, 1.0, 1.0)
        for got, want in zip(fused_cpadmm_tail(*args), cpadmm_tail_ref(*args)):
            close(got, want.cpu(), rel=1e-6)
    col, xs = rnd(n), rnd(B, n)
    for transpose in (False, True):
        close(matvec_ops.circulant_matvec_direct(col, xs, transpose=transpose),
              circulant_matvec_ref(col, xs, transpose=transpose).cpu(), rel=2e-5)
    assert counters() == [1, 2, 2, 0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n", [128, 1024, 16384])
@pytest.mark.parametrize("batch", [1, 3, 8, 16])
def test_circulant_matvec_matches_plain_version_on_card(batch, n, transpose, cuda_device,
                                                        counters):
    """The tensor-core kernel (bf16 hi + lo, three products) against the
    dense fp32 plain version, 5e-5 norm-relative (chip_smoke.py's
    TOL_MATVEC): one 8-signal slice padded (B = 1, 3), whole (B = 8) and two
    slices a block (B = 16)."""
    g = torch.Generator(device=cuda_device).manual_seed(n + batch)
    col, xs = (torch.randn(*s, generator=g, device=cuda_device) for s in ((n,), (batch, n)))
    close(matvec_ops.circulant_matvec_direct(col, xs, transpose=transpose),
          circulant_matvec_ref(col, xs, transpose=transpose).cpu(), rel=5e-5)
    assert counters() == [0, 0, 1, 0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["soft_threshold", "banded_conv"])
@pytest.mark.parametrize("n", [16384, 16383, 1000])  # a block multiple and ragged lengths
def test_slice2_kernels_match_plain_versions_on_card(kernel, n, cuda_device, counters):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x, other = (torch.randn(3, n, generator=g, device=cuda_device) for _ in range(2))
    if kernel == "soft_threshold":
        gamma = torch.tensor(0.5, device=cuda_device)  # read on the card, as CPISTA passes it
        close(fused_ista_update(x, other, gamma),
              ista_threshold_update_ref(x, other, gamma).cpu(), rel=1e-6)
        for got, want in zip(fused_admm_update(x, other, gamma, 1.6),
                             admm_threshold_dual_update_ref(x, other, gamma, 1.6)):
            close(got, want.cpu(), rel=1e-6)
        assert counters() == [0, 0, 0, 1, 1, 0]
    else:
        for order in (5, 17):
            taps = torch.randn(order, generator=g, device=cuda_device)
            close(blur_apply(taps, x, order=order),
                  banded_circulant_matvec_ref(taps, x, order=order).cpu(), rel=1e-5)
        assert counters() == [0, 0, 0, 0, 0, 2]


# the shapes the main path gives the soft-threshold pair: Path C (and Path
# F's dense ADMM), the CLI's default n, a ragged length
THRESHOLD_CARD_SHAPES = [(8, 16384), (4, 65536), (3, 16383)]


@pytest.mark.gpu
@pytest.mark.parametrize("config", threshold_kernel.SWEEP)
@pytest.mark.parametrize("shape", THRESHOLD_CARD_SHAPES)
def test_soft_threshold_pair_matches_plain_versions_on_card(shape, config, cuda_device):
    """The grid-stride kernels at every swept setting against their plain
    versions (1e-6, chip_smoke.py's TOL_ELEMENTWISE): eta_gamma(x + delta)
    with gamma on the card, the folded CPISTA form (tau on the card, alpha a
    number), and the ADMM pair with numbers and with device scalars."""
    g = torch.Generator(device=cuda_device).manual_seed(shape[1])
    x, other = (torch.randn(*shape, generator=g, device=cuda_device) for _ in range(2))
    gamma, tau = torch.tensor(0.5, device=cuda_device), torch.tensor(0.7, device=cuda_device)
    close(threshold_kernel.ista_update(x, other, gamma.reshape(1), config=config),
          ista_threshold_update_ref(x, other, gamma).cpu(), rel=1e-6)
    close(threshold_kernel.ista_update(x, other, 0.3, tau.reshape(1), config=config),
          ista_step_update_ref(x, other, tau, 0.3).cpu(), rel=1e-6)
    for g2, t2 in ((0.05, 1.0), (gamma.reshape(1), torch.tensor([1.6], device=cuda_device))):
        for got, want in zip(threshold_kernel.admm_update(x, other, g2, t2, config=config),
                             admm_threshold_dual_update_ref(x, other, g2, t2)):
            close(got, want.cpu(), rel=1e-6)


@pytest.mark.gpu
def test_folded_ista_wrapper_launches_once_on_card(cuda_device, counters):
    """CPISTA's update from the raw gradient: one launch, no fill for the
    numbers, and the same values as the unfolded call on tau * grad."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x, grad = (torch.randn(8, 16384, generator=g, device=cuda_device) for _ in range(2))
    tau = torch.tensor(0.9, device=cuda_device)
    got = fused_ista_update(x, grad, 1e-4, tau=tau)
    close(got, fused_ista_update(x, tau * grad, 1e-4 * tau).cpu(), rel=1e-6)
    assert counters() == [0, 0, 0, 2, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("n,batch", [(4096, 8), (1000, 3)])
def test_dense_kernel_step_matches_plain_step_on_card(n, batch, cuda_device, counters):
    """dense_admm_step_kernel (the n x n product, then the soft-threshold
    ADMM kernel) against dense_admm_step on the card, 20 steps, z within
    1e-4 (chip_smoke.py's TOL_PATHS); one kernel launch a step."""
    from repro_torch.core import admm
    from repro_torch.core.circulant import DenseOperator
    from repro_torch.core.kernel_backend import dense_admm_step_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(n)
    op = DenseOperator(torch.randn(n // 2, n, generator=g, device=cuda_device) / n**0.5)
    y = op.matvec(torch.randn(batch, n, generator=g, device=cuda_device))
    c = admm.dense_admm_setup(op, y, 0.01)
    s_plain = s_kernel = admm.dense_admm_init(op, y)
    for _ in range(20):
        s_plain = admm.dense_admm_step(c, s_plain, 1e-4, 0.01)
        s_kernel = dense_admm_step_kernel(c, s_kernel, 1e-4, 0.01)
    assert counters() == [0, 0, 0, 0, 20, 0]
    err = float((s_kernel.z - s_plain.z).norm() / s_plain.z.norm())
    assert err <= 1e-4, err


@pytest.mark.gpu
def test_floor_kernels_launch_on_card(cuda_device):
    """The empty kernels chip_smoke.py times as the launch floor, by both
    routes, one block and one a SM."""
    from repro_torch.kernels.floor import cuda_empty, triton_empty

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for blocks in (1, sms):
        triton_empty(cuda_device, blocks)
        cuda_empty(cuda_device, blocks)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_priors_on_card_match_the_cpu(cuda_device):
    """Each prior's apply on the card against the same call on the CPU,
    norm-relative within 1e-5, with a number and with a card tensor for
    gamma: the priors run no kernel of their own."""
    from repro_torch.ops.prox import NonNegL1Prox, TVProx, WaveletProx

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64 * 64, generator=g)
    for prox in (NonNegL1Prox(), TVProx(shape=(64, 64)), WaveletProx(),
                 WaveletProx(levels=3, wavelet="db4")):
        want = prox.apply(x, 0.05)
        for gamma in (0.05, torch.tensor(0.05, device=cuda_device)):
            got = prox.apply(x.to(cuda_device), gamma).cpu()
            err = float((got - want).norm() / want.norm())
            assert err <= 1e-5, (prox.tag, err)


@pytest.mark.gpu
def test_mapmaking_under_l1_runs_the_kernels_on_card(cuda_device, counters):
    """On the card the map-making plan resolves to the kernel step under
    l1 (one spectral_pointwise and one cpadmm_tail launch an iteration, and
    at n = 64^2, below FFT_CROSSOVER, one direct matvec; within 1e-4 of the
    plain step) and launches no kernel under TV."""
    from repro_torch.core.mapmaking import (
        build_mapmaking_plan,
        build_mapmaking_problem,
        solve_mapmaking,
    )
    from repro_torch.data.synthetic import extended_emission

    sky = extended_emission(torch.Generator().manual_seed(7), 64, 64, device=cuda_device)
    p = build_mapmaking_problem(torch.Generator().manual_seed(11), sky, [0, 1, 64, 65],
                                blur_order=1.5)
    pl = build_mapmaking_plan(p, prox=None)
    assert pl.tail == "kernel"
    z_k, _ = solve_mapmaking(p, plan=pl, iters=40)
    want = [40, 40, 40 if 64 * 64 < matvec_ops.FFT_CROSSOVER else 0, 0, 0, 0]
    assert counters() == want
    z_p, _ = solve_mapmaking(p, plan=build_mapmaking_plan(p, prox=None, tail="plain"), iters=40)
    assert float((z_k - z_p).norm() / z_p.norm()) <= 1e-4
    _, m = solve_mapmaking(p, iters=40)  # TV: the plain tail, whatever the device
    assert counters() == want and bool(torch.isfinite(m["map"]).all())
