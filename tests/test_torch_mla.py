"""MLA (DeepSeek-V3's multi-head latent attention) of the port against the reference.

Mirrors ``tests/test_blocks.py::test_mla_decode_matches_forward`` and both
cases of ``tests/test_mla_absorbed.py`` on the port, and holds the port's
``mla_forward``, ``mla_decode`` and ``mla_decode_absorbed`` against the
reference's functions on the same numbers: the reference's ``init_mla``
parameters and numpy inputs from a seed, carried across as numpy arrays.
deepseek-v3's SMOKE widths (4 heads, q / k head 16 + 8, v head 16, latent
16, q latent 32).

Tolerances: the mirrors keep the reference tests' own (3e-4 absolute for a
decode against the forward, 5e-3 for the whole-model absorbed decode);
against the reference, 1e-5 relative to the largest reference magnitude in
float32 (sums in another order) and ``tests/test_torch_lm.py``'s 2e-2 in
bf16 (torch and XLA round bf16 at other places).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as port_registry
from repro_torch.models import attention as A
from repro_torch.models import lm as port_lm
from repro_torch.models import steps as port_steps

REL_FP32 = 1e-5
REL_BF16 = 2e-2
B, S, MAX_LEN = 2, 10, 16


@pytest.fixture(scope="module")
def ref():
    """The reference's attention, loaded here so that the file imports on a
    card machine that has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.models import attention

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, registry=registry, attention=attention)


def rel_err(got, want) -> float:
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _cfg(dtype="float32", **kw):
    return dataclasses.replace(port_registry.smoke_config("deepseek-v3-671b"), dtype=dtype, **kw)


def _x(seed=1, b=B, s=S, d=64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, s, d))
                            .astype(np.float32) * np.float32(0.3))


def _carry(tree):
    """The reference's parameters -> torch tensors (nested dicts)."""
    if isinstance(tree, dict):
        return {k: _carry(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _port_params(ref, seed=0, **kw):
    """The reference's float32 init_mla parameters at deepseek's SMOKE
    config (with ``kw`` replaced) -> (its config, its parameters, the port's
    copy)."""
    rcfg = dataclasses.replace(ref.registry.smoke_config("deepseek_v3_671b"), dtype="float32",
                               **kw)
    theirs = ref.attention.init_mla(ref.jax.random.PRNGKey(seed), rcfg, ref.jnp.float32)
    return rcfg, theirs, _carry(theirs)


def _positions(b, s):
    return torch.arange(s).expand(b, s)


def _decode_all(fn, params, cfg, x, max_len=MAX_LEN):
    cache = A.init_mla_cache(cfg, x.shape[0], max_len, x.dtype, "cpu")
    outs = []
    for t in range(x.shape[1]):
        y, cache = fn(params, cfg, x[:, t:t + 1], cache)
        outs.append(y)
    return torch.cat(outs, dim=1), cache


# --------------------------------------------------------------------------
# mirrors of the reference's MLA tests
# --------------------------------------------------------------------------


def test_mla_decode_matches_forward():
    """tests/test_blocks.py::test_mla_decode_matches_forward on the port:
    feeding positions one at a time through the latent cache reproduces the
    parallel attention position by position."""
    cfg = _cfg()
    params = A.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = _x()
    full = A.mla_forward(params, cfg, x, _positions(B, S))
    dec, cache = _decode_all(A.mla_decode, params, cfg, x)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=3e-4)
    assert cache.length.tolist() == [S] * B


def test_absorbed_matches_naive_unit():
    """tests/test_mla_absorbed.py::test_absorbed_matches_naive_unit on the port."""
    cfg = _cfg()
    params = A.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = _x()
    c1 = A.init_mla_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    c2 = A.init_mla_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    for t in range(S):
        y1, c1 = A.mla_decode(params, cfg, x[:, t:t + 1], c1)
        y2, c2 = A.mla_decode_absorbed(params, cfg, x[:, t:t + 1], c2)
        np.testing.assert_allclose(y2.numpy(), y1.numpy(), atol=3e-4, err_msg=f"step {t}")
    np.testing.assert_allclose(c2.c_kv.numpy(), c1.c_kv.numpy(), atol=1e-5)


def test_absorbed_full_model_decode():
    """tests/test_mla_absorbed.py::test_absorbed_full_model_decode on the
    port: deepseek-smoke's decode with ``mla_absorbed`` True is finite and
    agrees with the naive configuration."""
    base = _cfg()
    params = port_lm.init_params(torch.Generator().manual_seed(0), base, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int64)
    outs = {}
    for absorbed in (False, True):
        cfg = dataclasses.replace(base, mla_absorbed=absorbed)
        state = port_lm.init_decode_state(cfg, 2, max_len=8, device="cpu")
        decode = port_steps.make_decode_step(cfg)
        for _ in range(3):
            logits, state = decode(params, tok, state)
        outs[absorbed] = logits.numpy()
        assert np.isfinite(outs[absorbed]).all()
    np.testing.assert_allclose(outs[True], outs[False], atol=5e-3)


# --------------------------------------------------------------------------
# against the reference's functions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("q_lora", [True, False], ids=["q-latent", "q-direct"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_reference(ref, dtype, q_lora):
    """The prefill (q / k head 24, v head 16: the plain ``_attend_chunked``
    with two head sizes), with the q latent and without it, at a chunk of 4
    keys so that the online softmax runs over several chunks and a ragged
    last one."""
    kw = dict(attn_chunk=4) if q_lora else dict(attn_chunk=4, q_lora_rank=0)
    cfg = _cfg(dtype, **kw)
    rcfg, theirs, ours = _port_params(ref, **kw)
    dt, rdt = getattr(torch, dtype), ref.jnp.dtype(dtype)
    x = _x()
    got = A.mla_forward(port_lm.tree_map(lambda a: a.to(dt), ours), cfg, x.to(dt),
                        _positions(B, S))
    want = ref.attention.mla_forward(
        ref.jax.tree.map(lambda a: a.astype(rdt), theirs), dataclasses.replace(rcfg, dtype=dtype),
        ref.jnp.asarray(x.numpy()).astype(rdt), ref.jnp.broadcast_to(ref.jnp.arange(S), (B, S)))
    assert got.dtype == dt and got.shape == (B, S, cfg.d_model)
    err = rel_err(got, np.asarray(want, np.float32))
    assert err <= (REL_FP32 if dtype == "float32" else REL_BF16), err


@pytest.mark.parametrize("absorbed", [False, True], ids=["naive", "absorbed"])
def test_mla_decode_matches_reference(ref, absorbed):
    """Each decode step's output and the latent cache against the
    reference's; the port writes the cache in place (the returned cache
    shares its tensors with the given one)."""
    cfg = _cfg()
    rcfg, theirs, ours = _port_params(ref, seed=3)
    fn = A.mla_decode_absorbed if absorbed else A.mla_decode
    rfn = ref.jax.jit(lambda p, x, c: (ref.attention.mla_decode_absorbed if absorbed
                                       else ref.attention.mla_decode)(p, rcfg, x, c))
    x = _x(seed=4)
    cache = A.init_mla_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    rcache = ref.attention.init_mla_cache(rcfg, B, MAX_LEN, ref.jnp.float32)
    for t in range(S):
        y, new = fn(ours, cfg, x[:, t:t + 1], cache)
        assert new.c_kv is cache.c_kv and new.k_rope is cache.k_rope
        cache = new
        ry, rcache = rfn(theirs, ref.jnp.asarray(x[:, t:t + 1].numpy()), rcache)
        assert rel_err(y, np.asarray(ry)) <= REL_FP32, t
    assert rel_err(cache.c_kv, np.asarray(rcache.c_kv)) <= REL_FP32
    assert rel_err(cache.k_rope, np.asarray(rcache.k_rope)) <= REL_FP32
    assert cache.length.tolist() == np.asarray(rcache.length).tolist() == [S] * B


def test_mla_never_reaches_flash_attention(monkeypatch):
    """The flash kernels take one D for q, k and v; MLA's q / k head (24)
    and v head (16) differ, so its prefill is the plain ``_attend_chunked``
    and must not call the kernel's wrapper, on any device."""
    def refuse(*a, **k):
        raise AssertionError("MLA called flash_attention")

    monkeypatch.setattr(A, "flash_attention", refuse)
    cfg = _cfg()
    params = port_lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    hidden, aux = port_lm.forward(params, cfg, torch.zeros((B, S), dtype=torch.int64))
    assert hidden.shape == (B, S, cfg.d_model) and bool(torch.isfinite(hidden).all())


def test_mla_cache_room_is_checked():
    """A full latent cache raises, as a full KV cache does, where the
    reference would overwrite its last position."""
    cfg = _cfg()
    params = port_lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    decode = port_steps.make_decode_step(cfg)
    state = port_lm.init_decode_state(cfg, B, 2, device="cpu")
    assert isinstance(state.segments[0], A.MLACache)
    tok = torch.zeros((B, 1), dtype=torch.int64)
    for _ in range(2):
        _, state = decode(params, tok, state)
    with pytest.raises(ValueError, match="MLA latent cache is full"):
        decode(params, tok, state)

