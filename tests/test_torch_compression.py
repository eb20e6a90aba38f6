"""CS gradient compression on the port (``repro_torch.core.compression``).

Mirrors ``tests/test_compression.py`` (with ``torch.Generator`` in place of
the reference's keys), the two decode cases of ``tests/test_prox.py`` and
``tests/dist_progs/compression_prog.py`` as a gloo test (8 ranks on the
CPU, as the reference's 8 XLA devices; the same checks).  The
decoder is also held against the reference's on the reference's own
operator and measurements, carried by
``repro_torch.interop.compressor_state_from_numpy``, at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_mesh_programs import compression_program

from repro.core import compression as ref_comp
from repro_torch import interop
from repro_torch.core.compression import (
    compress,
    compression_wire_bytes,
    decode,
    identity_wire_bytes,
    make_compressor,
    update_residual,
)
from repro_torch.data.synthetic import sparse_signal
from repro_torch.dist.compat import spawn_fake_devices
from repro_torch.ops.prox import L1Prox, NonNegL1Prox

DIM = 2048


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _compressor(seed, dim, **kw):
    return make_compressor(_gen(seed), dim, device="cpu", **kw)


def _sparse_grad(seed, k=DIM // 64):
    g = _gen(seed)
    sup = torch.randperm(DIM, generator=g)[:k]
    return torch.zeros(DIM).index_put_((sup,), torch.randn(k, generator=g))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def test_wire_reduction():
    spec, _ = _compressor(0, DIM, ratio=8)
    assert compression_wire_bytes(spec) * 8 == identity_wire_bytes(spec.n)
    assert (spec.n, spec.m) == (2048, 256)
    assert _compressor(0, 3000)[0].n == 4096 and _compressor(0, 1)[0].n == 8


def test_sparse_gradient_roundtrip():
    spec, st = _compressor(0, DIM, ratio=8, decode_iters=80)
    g = _sparse_grad(1)
    y, e = compress(spec, st, g)
    assert y.shape == (spec.m,)
    gh = decode(spec, st, y)[:DIM]
    err = float((gh - g).norm() / g.norm())
    assert err < 0.15, err


def test_error_feedback_accumulates_residual():
    """A gradient too dense to recover in one shot: error feedback carries
    the unrecovered part into the next compression."""
    spec, st = _compressor(0, DIM, ratio=8)
    g = torch.randn(DIM, generator=_gen(2)) * 0.1
    y, e = compress(spec, st, g)
    st2 = update_residual(st, e, decode(spec, st, y))
    assert float(st2.residual.norm()) > 0
    _, e2 = compress(spec, st2, g)
    np.testing.assert_allclose(e2.numpy(), (torch.nn.functional.pad(g, (0, spec.n - DIM))
                                            + st2.residual).numpy(), atol=1e-6)


def test_deterministic_operator_across_hosts():
    """The same seed builds the same sensing operator with no coordination."""
    _, a = _compressor(7, DIM)
    _, b = _compressor(7, DIM)
    assert torch.equal(a.col, b.col) and torch.equal(a.omega, b.omega)


def test_decode_matches_reference():
    """The reference's operator, gradient and measurements decode to the
    reference's answer, under l1 and non-negative l1."""
    for prox, ref_prox in ((None, None), (NonNegL1Prox(), None)):
        spec_r, st_r = ref_comp.make_compressor(jax.random.PRNGKey(0), DIM, ratio=8,
                                                decode_iters=80)
        if prox is not None:
            from repro.ops.prox import NonNegL1Prox as RefNonNeg

            ref_prox = RefNonNeg()
            spec_r = spec_r._replace(prox=ref_prox)
        g = jnp.zeros(DIM).at[jax.random.permutation(jax.random.PRNGKey(1), DIM)[:32]].set(
            jax.random.normal(jax.random.PRNGKey(2), (32,)))
        y_r, e_r = ref_comp.compress(spec_r, st_r, g)
        st = interop.compressor_state_from_numpy(np.asarray(st_r.col), np.asarray(st_r.omega),
                                                 np.asarray(st_r.residual), device="cpu")
        spec, _ = _compressor(0, DIM, ratio=8, decode_iters=80, prox=prox)
        assert (spec.n, spec.m) == (spec_r.n, spec_r.m)
        y, e = compress(spec, st, torch.from_numpy(np.array(g)))
        assert _rel(y.numpy(), y_r) <= 1e-5 and _rel(e.numpy(), e_r) <= 1e-6
        got = decode(spec, st, torch.from_numpy(np.array(y_r)))
        assert _rel(got.numpy(), ref_comp.decode(spec_r, st_r, y_r)) <= 1e-5, prox


def test_compression_decode_l1_bitwise():
    """The default spec (prox=None) decodes bit-equal to an explicit L1Prox."""
    spec0, state = _compressor(0, 200, ratio=4)
    spec1, _ = _compressor(0, 200, ratio=4, prox=L1Prox())
    assert spec0.prox is None and isinstance(spec1.prox, L1Prox)
    g = sparse_signal(_gen(2), spec0.n, 12, device="cpu")
    y = torch.fft.irfft(torch.fft.rfft(state.col) * torch.fft.rfft(g), n=spec0.n)[state.omega]
    assert torch.equal(decode(spec0, state, y), decode(spec1, state, y))


def test_compression_decode_nonneg_prox():
    spec, state = _compressor(1, 200, ratio=4, prox=NonNegL1Prox())
    x = decode(spec, state, torch.randn(spec.m, generator=_gen(3)))
    assert float(x.min()) >= 0.0


RANKS, PROG_DIM, RATIO = 8, 4096, 8


def test_compressed_mean_over_gloo_ranks():
    """The mean of the ranks' sparse gradients through m = n/8 floats a
    rank: a low one-shot error, the same answer on every rank, and with
    error feedback the time-averaged decode converges on the true mean."""
    ranks = spawn_fake_devices(RANKS, compression_program, RANKS, PROG_DIM, RATIO)
    r0 = ranks[0]
    assert r0["wire"] * (RATIO - 1) < identity_wire_bytes(PROG_DIM)
    assert r0["err"] < 0.35, r0["err"]
    assert r0["err_avg"] < r0["err"] * 0.7, (r0["err_avg"], r0["err"])
    assert all(torch.equal(r["out"], r0["out"]) for r in ranks[1:])
