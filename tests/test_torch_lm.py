"""The port's LM (config, layers, attention, lm, steps) against the reference.

For each of the eight decoder-only ``SMOKE`` configs (four dense, moonshot's
MoE, deepseek-v3's MoE over MLA, the zamba2 hybrid, xlstm;
``tests/test_torch_moe.py`` holds the MoE layer itself and its routing
margins, ``tests/test_torch_mla.py``, ``test_torch_ssm.py`` and
``test_torch_xlstm.py`` the new blocks; the configs, counts and parameter
trees of all ten, whisper-large-v3's encoder-decoder and pixtral-12b's image
prefix among them, whose paths are in ``tests/test_torch_encdec.py``) the
reference's parameters
(``repro.models.lm.init_params`` from a PRNG key) are carried across with
``repro_torch.interop.lm_params_from_numpy`` and the tokens are made with
numpy from a seed, so both packages compute on the same numbers.  Prefill
attention runs the flash kernel's plain version on the CPU at a head size
the kernels have (gemma's 32), the reference's chunked attention at the
others (8 and 16).

Tolerances, relative to the largest reference magnitude: 1e-5 in float32
(sums in another order: the plain flash attention against the reference's
chunked online softmax); 2e-2 in bf16, where gemma's prefill takes the
kernel's function, which upcasts q before scaling it, and the reference
rounds q * scale to bf16 first; torch and XLA also round bf16 at other
places.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as port_registry
from repro_torch.data.synthetic import token_batch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models import lm as port_lm
from repro_torch.models import steps as port_steps
from repro_torch.models.config import count_params

DENSE = ["minitron-4b", "codeqwen1.5-7b", "gemma-7b", "granite-34b"]
MOE = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]
ARCHS = DENSE + MOE + ["zamba2-1.2b", "xlstm-350m"]
ALL_ARCHS = ARCHS + ["pixtral-12b", "whisper-large-v3"]
REL_FP32 = 1e-5
REL_BF16 = 2e-2
B, S, DECODE_STEPS = 2, 24, 8


@pytest.fixture(scope="module")
def ref():
    """The reference's LM.  Loaded here rather than at the top so that the
    file imports on a card machine that has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.models import attention, layers, lm, steps
    from repro.models import config as config_mod

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, registry=registry, lm=lm,
                                 steps=steps, layers=layers, attention=attention,
                                 config=config_mod)


def rel_err(got, want) -> float:
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def close(got, want, rel):
    err = rel_err(got, want)
    assert err <= rel, f"norm-relative error {err:.3e} > {rel:.0e}"


def f32(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def case(ref):
    """(arch, dtype) -> the reference's config and parameters, the port's
    carried copy, and the prompt; each built once per module."""
    built = {}

    def get(arch, dtype):
        if (arch, dtype) not in built:
            cfg = dataclasses.replace(ref.registry.smoke_config(arch), dtype=dtype)
            pcfg = dataclasses.replace(port_registry.smoke_config(arch), dtype=dtype)
            params = ref.lm.init_params(ref.jax.random.PRNGKey(0), cfg)
            tree = ref.jax.tree.map(np.asarray, params)
            tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
            built[arch, dtype] = types.SimpleNamespace(
                cfg=cfg, pcfg=pcfg, params=params,
                pparams=lm_params_from_numpy(tree, pcfg, "cpu"),
                tokens=tokens, ptokens=torch.as_tensor(tokens, dtype=torch.int64))
        return built[arch, dtype]

    return get


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_and_counts_match_reference(ref, arch):
    for size in ("full_config", "smoke_config"):
        want = getattr(ref.registry, size)(arch)
        got = getattr(port_registry, size)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.layer_kinds() == want.layer_kinds()
        assert got.vocab_padded == want.vocab_padded
        assert count_params(got) == ref.config.count_params(want)


def test_minitron_full_size():
    cfg = port_registry.full_config("minitron-4b")
    n = count_params(cfg)["total"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == (32, 3072, 24, 8)
    assert 4.1e9 < n < 4.3e9  # ~4.19 B: 1.57 B of (un)embedding, 32 x 81.8 M


# tests/test_arch_smoke.py::test_full_param_counts_match_scale's table:
# billions, relative tolerance (moonshot follows the assigned 48 layers x 64
# experts, not the HF model's 27 layers)
FULL_COUNTS = {
    "codeqwen15_7b": (8.2, 0.1),
    "granite_34b": (34, 0.1),
    "gemma_7b": (8.5, 0.1),
    "deepseek_v3_671b": (671, 0.05),
    "moonshot_v1_16b_a3b": (28.4, 0.1),
    "pixtral_12b": (12.3, 0.1),
    "xlstm_350m": (0.35, 0.25),
    "whisper_large_v3": (1.6, 0.15),
    "minitron_4b": (4.2, 0.1),
    "zamba2_1p2b": (1.2, 0.15),
}


@pytest.mark.parametrize("arch", port_registry.all_arch_ids())
def test_full_param_counts_match_scale(arch):
    """Mirror of tests/test_arch_smoke.py::test_full_param_counts_match_scale,
    one case an architecture: the port's FULL config lands near its
    nominal count."""
    nominal, tol = FULL_COUNTS[arch]
    total = count_params(port_registry.full_config(arch))["total"] / 1e9
    assert abs(total - nominal) / nominal < tol, (arch, total, nominal)


def test_registry_runs_all_ten_ids():
    assert sorted(port_registry.all_arch_ids()) == sorted(FULL_COUNTS)
    with pytest.raises(ValueError, match="unknown arch"):
        port_registry.full_config("llama-9000")


FIRST_WEIGHT = {"deepseek-v3-671b": ("attn", "w_dkv"), "zamba2-1.2b": ("mamba", "in_proj"),
                "xlstm-350m": ("mlstm", "w_up")}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_mirrors_reference_tree(case, arch):
    c = case(arch, "float32")
    mine = port_lm.init_params(torch.Generator().manual_seed(0), c.pcfg, device="cpu")
    shapes = lambda tree: port_lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), tree)
    want = port_lm.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), c.pparams)
    assert shapes(mine) == want
    # truncated normal in [-3, 3] times d_in**-0.5, on a weight of d_model inputs
    block, name = FIRST_WEIGHT.get(arch, ("attn", "wq"))
    w = mine["segments"][0][block][name]
    std = c.pcfg.d_model**-0.5
    assert float(w.abs().max()) <= 3 * std
    assert abs(float(w.std()) / std - 0.9866) < 0.05  # the std of N(0, 1) cut at +-3


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_layers_match_reference(ref):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    close(port_layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4),
          ref.layers.apply_rope(ref.jnp.asarray(x), ref.jnp.asarray(pos), 1e4), REL_FP32)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    scale = {"scale": rng.standard_normal(32).astype(np.float32)}
    for kind in ("rmsnorm", "layernorm"):
        close(port_layers.apply_norm({"scale": torch.as_tensor(scale["scale"])},
                                     torch.as_tensor(h), kind),
              ref.layers.apply_norm(scale, ref.jnp.asarray(h), kind), REL_FP32)
    for variant, act in (("glu", "silu"), ("glu", "gelu"), ("plain", "silu")):
        w = {k: rng.standard_normal(s).astype(np.float32) / 6 for k, s in
             (("w_up", (32, 48)), ("w_down", (48, 32)), ("w_gate", (32, 48)))
             if variant == "glu" or k != "w_gate"}
        close(port_layers.mlp({k: torch.as_tensor(v) for k, v in w.items()},
                              torch.as_tensor(h), act),
              ref.layers.mlp(w, ref.jnp.asarray(h), act), REL_FP32)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, q_offset=3, sliding_window=5),
                                dict(causal=False, kv_valid=True)],
                         ids=["causal", "full", "offset-window", "valid-len"])
def test_attend_chunked_matches_reference(ref, kw):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 20, 6, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 20, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(kw)
    valid = np.array([7, 20], np.int32) if kw.pop("kv_valid", False) else None
    got = port_attn._attend_chunked(
        *(torch.as_tensor(a) for a in (q, k, v)), chunk=8,
        kv_valid_len=None if valid is None else torch.as_tensor(valid), **kw)
    want = ref.attention._attend_chunked(
        *(ref.jnp.asarray(a) for a in (q, k, v)), chunk=8,
        kv_valid_len=None if valid is None else ref.jnp.asarray(valid), **kw)
    close(got, want, REL_FP32)


# --------------------------------------------------------------------------
# the slice: forward, prefill, decode, greedy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(ref, case, arch):
    c = case(arch, "float32")
    want, want_aux = ref.jax.jit(lambda p, t: ref.lm.forward(p, c.cfg, t))(c.params, c.tokens)
    got, aux = port_lm.forward(c.pparams, c.pcfg, c.ptokens)
    close(got, want, REL_FP32)
    if arch not in MOE:
        assert float(aux) == float(want_aux) == 0.0
    else:  # the MoE layers' Switch loss
        close(aux, want_aux, REL_FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(ref, case, arch, dtype):
    c = case(arch, dtype)
    want = ref.jax.jit(ref.steps.make_prefill_step(c.cfg))(c.params, {"tokens": c.tokens})
    got = port_steps.make_prefill_step(c.pcfg)(c.pparams, {"tokens": c.ptokens})
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, c.cfg.vocab_padded)
    close(got, f32(want), REL_FP32 if dtype == "float32" else REL_BF16)


def _reference_decode(ref, c, steps, max_len=S):
    decode = ref.jax.jit(ref.steps.make_decode_step(c.cfg))
    state = ref.lm.init_decode_state(c.cfg, B, max_len)
    out = []
    for i in range(steps):
        logits, state = decode(c.params, c.tokens[:, i:i + 1], state)
        out.append(f32(logits))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_reference(ref, case, arch):
    c = case(arch, "float32")
    want = _reference_decode(ref, c, DECODE_STEPS)
    decode = port_steps.make_decode_step(c.pcfg)
    state = port_lm.init_decode_state(c.pcfg, B, S, device="cpu")
    for i in range(DECODE_STEPS):
        logits, state = decode(c.pparams, c.ptokens[:, i:i + 1], state)
        close(logits, want[i], REL_FP32)
    assert [int(seg.length.max()) for seg in state.segments] == [DECODE_STEPS] * len(
        port_lm.segments_of(c.pcfg))
    if arch == "zamba2-1.2b":  # one shared position a token per invocation (2 at SMOKE)
        assert port_lm.shared_invocations(c.pcfg) == 2
        assert int(state.shared_attn.length.max()) == 2 * DECODE_STEPS
    else:
        assert state.shared_attn is None


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_reference(ref, case, arch):
    c = case(arch, "float32")
    prompt = c.tokens[:, :6]
    # zamba2's shared cache takes one position a token per invocation
    max_len = 16 * max(1, port_lm.shared_invocations(c.pcfg))
    want = ref.steps.greedy_generate(c.params, c.cfg, ref.jnp.asarray(prompt), 6, max_len)
    got = port_steps.greedy_generate(c.pparams, c.pcfg, torch.as_tensor(prompt).long(), 6,
                                     max_len)
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DENSE + ["xlstm-350m"])
def test_prefill_matches_own_decode(case, arch):
    """The kernel's function (prefill) against the cache path (decode), both
    the port's: the last prefill logits equal the decode logits after the
    whole prompt (xlstm: the chunked mLSTM and the sLSTM loop against their
    recurrent steps).  Not for an MoE model, whose decode routes B tokens a
    step under another capacity than the prefill, on both sides
    (``tests/test_torch_moe.py``), nor for zamba2, whose shared cache is
    shared across invocations (``test_zamba2_decode_disagrees_with_prefill_
    as_the_reference_does``)."""
    c = case(arch, "float32")
    prefill = port_steps.make_prefill_step(c.pcfg)(c.pparams, {"tokens": c.ptokens})
    decode = port_steps.make_decode_step(c.pcfg)
    state = port_lm.init_decode_state(c.pcfg, B, S, device="cpu")
    for i in range(S):
        logits, state = decode(c.pparams, c.ptokens[:, i:i + 1], state)
    close(logits, prefill.numpy(), REL_FP32)


def test_zamba2_decode_disagrees_with_prefill_as_the_reference_does(ref, case):
    """The reference's fault, kept: zamba2's decode carries one shared KV
    cache through the layers and every invocation of the shared block
    appends to it, so after 8 tokens it holds 16 positions (2 invocations a
    token at SMOKE) and each invocation attends over the keys of both.  The
    port's decode equals the reference's, and both differ from the prefill
    of the same 8 tokens by more than 0.1."""
    c = case("zamba2-1.2b", "float32")
    n = 8
    want_prefill = f32(ref.jax.jit(ref.steps.make_prefill_step(c.cfg))(
        c.params, {"tokens": c.tokens[:, :n]}))
    got_prefill = port_steps.make_prefill_step(c.pcfg)(c.pparams, {"tokens": c.ptokens[:, :n]})
    close(got_prefill, want_prefill, REL_FP32)
    want = _reference_decode(ref, c, n, max_len=2 * n)[-1]
    decode = port_steps.make_decode_step(c.pcfg)
    state = port_lm.init_decode_state(c.pcfg, B, 2 * n, device="cpu")
    for i in range(n):
        logits, state = decode(c.pparams, c.ptokens[:, i:i + 1], state)
    close(logits, want, REL_FP32)
    assert int(state.shared_attn.length.max()) == 2 * n
    assert float(np.abs(want - want_prefill).max()) > 0.1
    assert float((logits - got_prefill).abs().max()) > 0.1
    with pytest.raises(ValueError, match="per invocation of the shared block"):
        decode(c.pparams, c.ptokens[:, n:n + 1], state)


def test_step_functions_cast_once(case, monkeypatch):
    c = case("minitron-4b", "bfloat16")
    calls = []
    real = port_lm.cast_params
    monkeypatch.setattr(port_lm, "cast_params",
                        lambda params, cfg: calls.append(1) or real(params, cfg))
    step = port_steps.make_decode_step(c.pcfg)
    state = port_lm.init_decode_state(c.pcfg, B, S, device="cpu")
    for i in range(3):
        _, state = step(c.pparams, c.ptokens[:, i:i + 1], state)
    # one cast of the float32 tree by the step function, none in lm's
    assert len(calls) == 1
    _, state = step(dict(c.pparams), c.ptokens[:, 3:4], state)  # the same tensors
    assert len(calls) == 1
    with torch.no_grad():  # an in-place write, as an optimizer's step makes
        c.pparams["final_norm"]["scale"].add_(0.0)
    _, state = step(c.pparams, c.ptokens[:, 4:5], state)
    assert len(calls) == 2


def test_decode_writes_cache_in_place_and_raises_when_full(case):
    """The port writes each new key and value into the caller's cache (the
    reference returns new caches): a state once decoded from shares its
    tensors with the next.  A full cache raises where the reference would
    overwrite its last position."""
    c = case("minitron-4b", "float32")
    step = port_steps.make_decode_step(c.pcfg)
    first = port_lm.init_decode_state(c.pcfg, B, 2, device="cpu")
    _, second = step(c.pparams, c.ptokens[:, :1], first)
    old, new = first.segments[0], second.segments[0]
    assert new.k is old.k and new.v is old.v
    assert int(old.length.max()) == 0 and int(new.length.min()) == 1
    assert bool(old.k[:, :, 0].abs().amax() > 0)  # the first state sees the write
    _, third = step(c.pparams, c.ptokens[:, 1:2], second)
    with pytest.raises(ValueError, match="KV cache is full"):
        step(c.pparams, c.ptokens[:, 2:3], third)


def test_token_batch_shape_range_and_head_share():
    vocab = 6400
    t = token_batch(torch.Generator().manual_seed(0), 8, 511, vocab, device="cpu")
    assert t.shape == (8, 512) and t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) < vocab
    head = vocab // 64
    # P(id < head) = 0.8 + 0.2 * head / vocab
    share = float((t < head).float().mean())
    assert abs(share - (0.8 + 0.2 * head / vocab)) < 0.02
    again = token_batch(torch.Generator().manual_seed(0), 8, 511, vocab, device="cpu")
    assert torch.equal(t, again)

