"""The Mamba-2 (SSD) block of the port against the reference, and zamba2's hybrid wiring.

Mirrors ``tests/test_blocks.py::test_ssd_chunked_matches_naive`` and
``::test_mamba2_decode_matches_forward`` on the port (their own
tolerances), and holds the port's ``_causal_conv``, ``_ssd_chunked``,
``mamba2_forward`` and ``mamba2_decode`` against the reference's functions
on the same numbers: the reference's ``init_mamba2`` parameters and numpy
inputs from a seed, carried across as numpy arrays.  zamba2's SMOKE widths
(d_model 64, 8 SSM heads of 16 over 2 groups, state 16, conv 4).

Tolerances against the reference: 1e-5 relative to the largest reference
magnitude in float32 (sums in another order; the chunk products contracted
pairwise in another order than XLA's) and ``tests/test_torch_lm.py``'s
2e-2 in bf16.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import registry as port_registry
from repro_torch.models import lm as port_lm
from repro_torch.models import ssm as ssm_mod

REL_FP32 = 1e-5
REL_BF16 = 2e-2


@pytest.fixture(scope="module")
def ref():
    """The reference's SSM block, loaded here so that the file imports on a
    card machine that has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.models import ssm

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, registry=registry, ssm=ssm)


def rel_err(got, want) -> float:
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _cfg(dtype="float32"):
    return dataclasses.replace(port_registry.smoke_config("zamba2-1.2b"), dtype=dtype)


def _normal(seed, *shape, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def _ref_params(ref, seed=0):
    """The reference's float32 init_mamba2 parameters -> (its config, them,
    the port's copy)."""
    rcfg = dataclasses.replace(ref.registry.smoke_config("zamba2_1p2b"), dtype="float32")
    theirs = ref.ssm.init_mamba2(ref.jax.random.PRNGKey(seed), rcfg, ref.jnp.float32)
    return rcfg, theirs, port_lm.tree_map(lambda a: torch.from_numpy(np.array(a)), theirs)


def _ssd_inputs(seed, bt=2, t=256, h=4, p=8, g=2, n=16):
    """test_blocks.py's SSD inputs, drawn with numpy: x, dt (softplus of a
    normal - 1), a_log, B, C (normals * 0.3), d_skip."""
    x = _normal(seed, bt, t, h, p)
    dt = F.softplus(_normal(seed + 1, bt, t, h) - 1.0)
    a_log = torch.log(torch.linspace(0.5, 2.0, h))
    B, C = _normal(seed + 2, bt, t, g, n, scale=0.3), _normal(seed + 3, bt, t, g, n, scale=0.3)
    return x, dt, a_log, B, C, torch.ones(h)


def _naive_ssd(x, dt, a_log, B, C, d_skip):
    """The direct recurrence h_t = a_t h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t
    + D x_t (test_blocks.py's oracle, in torch)."""
    bt, t, h, p = x.shape
    rep = h // B.shape[2]
    A = -torch.exp(a_log)
    Bh, Ch = B.repeat_interleave(rep, dim=2), C.repeat_interleave(rep, dim=2)
    state = torch.zeros((bt, h, B.shape[3], p))
    ys = []
    for i in range(t):
        a = torch.exp(dt[:, i] * A)
        state = state * a[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhnp", dt[:, i], Bh[:, i], x[:, i])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, i], state))
    return torch.stack(ys, dim=1) + x * d_skip[None, None, :, None]


# --------------------------------------------------------------------------
# mirrors of the reference's SSM tests
# --------------------------------------------------------------------------


def test_ssd_chunked_matches_naive():
    """tests/test_blocks.py::test_ssd_chunked_matches_naive on the port:
    four chunks of 64 against the per-step recurrence."""
    args = _ssd_inputs(0)
    got, _ = ssm_mod._ssd_chunked(*args, chunk=64)
    np.testing.assert_allclose(got.numpy(), _naive_ssd(*args).numpy(), rtol=2e-3, atol=2e-3)


def test_mamba2_decode_matches_forward():
    """tests/test_blocks.py::test_mamba2_decode_matches_forward on the port:
    one full chunk fed one position at a time through the recurrent step."""
    cfg = _cfg()
    params = ssm_mod.init_mamba2(torch.Generator().manual_seed(0), cfg, torch.float32)
    b, s = 2, ssm_mod.CHUNK
    x = _normal(1, b, s, cfg.d_model, scale=0.3)
    full = ssm_mod.mamba2_forward(params, cfg, x)
    cache = ssm_mod.init_mamba2_cache(cfg, b, torch.float32, "cpu")
    outs = []
    for t in range(s):
        y, cache = ssm_mod.mamba2_decode(params, cfg, x[:, t:t + 1], cache)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), rtol=3e-3,
                               atol=3e-3)
    assert cache.length.tolist() == [s] * b


# --------------------------------------------------------------------------
# against the reference's functions
# --------------------------------------------------------------------------


def test_ssd_chunked_matches_reference(ref):
    """The outputs and the final state, at the reference's CHUNK = 128 over
    two chunks and at chunks of 32 (eight)."""
    args = _ssd_inputs(5)
    for chunk in (ssm_mod.CHUNK, 32):
        got_y, got_h = ssm_mod._ssd_chunked(*args, chunk=chunk)
        want_y, want_h = ref.ssm._ssd_chunked(*(ref.jnp.asarray(a.numpy()) for a in args),
                                              chunk=chunk)
        assert rel_err(got_y, np.asarray(want_y)) <= REL_FP32, chunk
        assert rel_err(got_h, np.asarray(want_h)) <= REL_FP32, chunk


def test_causal_conv_matches_reference(ref):
    cfg = _cfg()
    xbc, w, b = _normal(6, 2, 9, 96), _normal(7, 4, 96, scale=0.1), _normal(8, 96, scale=0.1)
    got = ssm_mod._causal_conv(cfg, xbc, w, b)
    want = ref.ssm._causal_conv(None, *(ref.jnp.asarray(a.numpy()) for a in (xbc, w, b)))
    assert rel_err(got, np.asarray(want)) <= REL_FP32


@pytest.mark.parametrize("s", [40, 200], ids=["one-ragged-chunk", "two-chunks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_matches_reference(ref, dtype, s):
    """A prompt shorter than a chunk and one over two chunks (both padded
    to CHUNK inside)."""
    rcfg, theirs, ours = _ref_params(ref)
    dt, rdt = getattr(torch, dtype), ref.jnp.dtype(dtype)
    x = _normal(2, 2, s, rcfg.d_model, scale=0.5)
    got = ssm_mod.mamba2_forward(port_lm.tree_map(lambda a: a.to(dt), ours), _cfg(dtype),
                                 x.to(dt))
    want = ref.ssm.mamba2_forward(ref.jax.tree.map(lambda a: a.astype(rdt), theirs),
                                  dataclasses.replace(rcfg, dtype=dtype),
                                  ref.jnp.asarray(x.numpy()).astype(rdt))
    assert got.dtype == dt and got.shape == x.shape
    err = rel_err(got, np.asarray(want, np.float32))
    assert err <= (REL_FP32 if dtype == "float32" else REL_BF16), err


def test_mamba2_decode_matches_reference(ref):
    """Each step's output, conv window and state against the reference's;
    the port's step returns a new cache and leaves the given one as it
    was."""
    rcfg, theirs, ours = _ref_params(ref, seed=3)
    cfg = _cfg()
    rstep = ref.jax.jit(lambda p, x, c: ref.ssm.mamba2_decode(p, rcfg, x, c))
    x = _normal(4, 2, 12, cfg.d_model, scale=0.5)
    cache = ssm_mod.init_mamba2_cache(cfg, 2, torch.float32, "cpu")
    rcache = ref.ssm.init_mamba2_cache(rcfg, 2, ref.jnp.float32)
    for t in range(x.shape[1]):
        before = cache.state.clone()
        y, new = ssm_mod.mamba2_decode(ours, cfg, x[:, t:t + 1], cache)
        assert torch.equal(cache.state, before)
        cache = new
        ry, rcache = rstep(theirs, ref.jnp.asarray(x[:, t:t + 1].numpy()), rcache)
        assert rel_err(y, np.asarray(ry)) <= REL_FP32, t
    assert rel_err(cache.state, np.asarray(rcache.state)) <= REL_FP32
    assert rel_err(cache.conv, np.asarray(rcache.conv)) <= REL_FP32


def test_zamba2_shared_block_follows_the_global_layer_index(monkeypatch):
    """The shared block runs after every layer whose global index is a
    multiple of attn_every: at FULL (38 layers, every 6th) after layers 0,
    6, ..., 36, 7 a token, and so 7 positions of the shared cache a decoded
    token; at SMOKE (4, every 2nd) after 0 and 2."""
    full = port_registry.full_config("zamba2-1.2b")
    assert port_lm.shared_invocations(full) == 7
    assert [i for i in range(full.n_layers) if port_lm._applies_shared(full, {}, i)] == \
        list(range(0, 38, 6))
    cfg = _cfg()
    params = port_lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert sorted(params["shared_attn"]) == ["attn", "ln1", "ln2", "mlp"]
    seen = []
    real = port_lm._shared_block
    monkeypatch.setattr(port_lm, "_shared_block",
                        lambda *a: seen.append(a[2].shape) or real(*a))
    port_lm.forward(params, cfg, torch.zeros((2, 5), dtype=torch.int64))
    assert len(seen) == port_lm.shared_invocations(cfg) == 2
