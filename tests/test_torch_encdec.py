"""The port's whisper-large-v3 encoder-decoder and pixtral-12b image prefix against the reference.

For each of the two ``SMOKE`` configs the reference's parameters
(``repro.models.lm.init_params`` from a PRNG key) are carried across with
``repro_torch.interop.lm_params_from_numpy``; tokens, Whisper's frames (the
stubbed post-conv embeddings, N(0, 0.02^2)) and pixtral's image embeddings
are made with numpy from a seed, so both packages compute on the same
numbers.  Every attention the two models run outside the decode cache goes
through the flash kernel's function (its plain version on the CPU):
Whisper's non-causal encoder, its causal decoder and its cross-attention,
at Sq != Sk in the prefill and at Sq = 1 in decode.

Tolerances, relative to the largest reference magnitude, as
``tests/test_torch_lm.py`` and ``tests/test_torch_train.py`` hold the other
eight configs: 1e-5 in float32 (the plain flash attention against the
reference's chunked online softmax: sums in another order), 2e-2 for a bf16
prefill (the reference rounds q * scale to bf16 before the upcast, the
kernel's function does not); ``loss_fn``'s loss 1e-5, each gradient leaf
1e-4; the flash Function's gradient 1e-6 against autograd through the plain
function (the same float32 operations).

Two faults of the reference are pinned (ROADMAP.md Queue 3): Whisper's
decode adds no position to its token, so it does not agree with its own
prefill, and pixtral's ``loss_fn`` without ``img_embeds`` fails on a shape
mismatch or scores misaligned positions (the port raises ``ValueError``).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as port_registry
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models import lm as port_lm
from repro_torch.models import steps as port_steps
from repro_torch.optim import adamw as port_adamw

ARCHS = ["whisper-large-v3", "pixtral-12b"]
REL_FP32 = 1e-5
REL_BF16 = 2e-2
B, S, S_ENC, DECODE_STEPS = 2, 16, 24, 8


@pytest.fixture(scope="module")
def ref():
    """The reference's LM, loaded in a fixture so that the file imports on a
    card machine that has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.models import layers, lm, steps

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, registry=registry, lm=lm,
                                 steps=steps, layers=layers)


def rel_err(got, want) -> float:
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def close(got, want, rel, what=""):
    err = rel_err(got, want)
    assert err <= rel, f"{what}: norm-relative error {err:.3e} > {rel:.0e}"


def f32(a):
    return np.asarray(a, np.float32)


def _paths(tree, prefix=()):
    """(path, leaf) of nested dicts and lists, dicts by sorted key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def extras(cfg, seed=2) -> dict:
    """The inputs beside the tokens that ``cfg`` takes, numpy float32:
    ``frames`` (B, S_ENC, D) for an encoder-decoder, ``img_embeds`` (B,
    n_img_tokens, D) for a VLM."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encdec:
        out["frames"] = (rng.standard_normal((B, S_ENC, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.n_img_tokens:
        out["img_embeds"] = (rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model))
                             * 0.02).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def case(ref):
    """(arch, dtype) -> the reference's config and parameters, the port's
    carried copy, the tokens (B, S + 1) and the extra inputs; each built
    once per module."""
    built = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in built:
            cfg = dataclasses.replace(ref.registry.smoke_config(arch), dtype=dtype)
            pcfg = dataclasses.replace(port_registry.smoke_config(arch), dtype=dtype)
            params = ref.lm.init_params(ref.jax.random.PRNGKey(0), cfg)
            tree = ref.jax.tree.map(np.asarray, params)
            tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
            ex = extras(cfg)
            built[arch, dtype] = types.SimpleNamespace(
                cfg=cfg, pcfg=pcfg, params=params, tree=tree,
                pparams=lm_params_from_numpy(tree, pcfg, "cpu"), tokens=tokens,
                ptokens=torch.as_tensor(tokens, dtype=torch.int64), extras=ex,
                pextras={k: torch.as_tensor(v) for k, v in ex.items()})
        return built[arch, dtype]

    return get


# --------------------------------------------------------------------------
# layers and the flash Function
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(24, 64), (7, 10), (1500, 1280)])
def test_sinusoidal_positions_match_reference(ref, n, d):
    """The same float32 operations; XLA's exp and torch's round some
    frequencies an ulp apart (freq <= 1: 2^-24), which position p multiplies
    into the angle: up to p 2^-23 at the table's last row.  So 1e-5 at the
    SMOKE lengths and n 2^-23 (1.8e-4) at Whisper's 1500 frames, where each
    table is as far from the float64 one."""
    got = port_layers.sinusoidal_positions(n, d)
    want = ref.layers.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    tol = max(REL_FP32, n * 2.0**-23)
    close(got, want, tol)
    half = d // 2
    args = np.arange(n)[:, None] * np.exp(-np.log(1e4) * np.arange(half) / (half - 1))[None]
    exact = np.concatenate([np.sin(args), np.cos(args)], axis=-1)
    assert rel_err(got, exact) <= tol and rel_err(want, exact) <= tol


@pytest.mark.parametrize("sq,sk,chunk", [(20, 44, 16), (40, 12, 16), (1, 30, 8), (24, 24, 16)],
                         ids=["Sq<Sk", "Sq>Sk", "Sq=1", "Sq=Sk"])
def test_flash_function_noncausal_gradient_is_the_plain_functions(sq, sk, chunk):
    """FlashAttentionFn with causal=False and K / V of another length than
    Q: the forward is the kernel's function (its plain version here), the
    gradients autograd through _attend_chunked(causal=False), one query tile
    at a time (1e-6, the same float32 operations)."""
    g = torch.Generator().manual_seed(sq + sk)
    q = torch.randn(2, sq, 4, 16, generator=g)
    k, v = (torch.randn(2, sk, 2, 16, generator=g) for _ in range(2))
    dout = torch.randn(2, sq, 4, 16, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = port_attn.FlashAttentionFn.apply(*leaves, chunk, False)
    assert torch.equal(out, port_attn.flash_attention(q, k, v, causal=False))
    got = torch.autograd.grad(out, leaves, dout)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = port_attn._attend_chunked(*plain, causal=False, chunk=chunk)
    want = torch.autograd.grad(want_out, plain, dout)
    close(out, want_out.detach().numpy(), 1e-6, "out")
    for name, a, b in zip("qkv", got, want):
        close(a, b.numpy(), 1e-6, f"d{name}")


def test_gqa_forward_routes_every_whisper_attention_to_flash(monkeypatch):
    """Whisper's non-causal encoder, causal decoder and cross-attention all
    call flash_attention (with grad through FlashAttentionFn): n_enc_layers
    + 2 n_layers calls a forward; a decode step calls it once a layer (the
    cross-attention at Sq = 1; the self-attention reads its cache through
    _attend_chunked)."""
    calls = {"fn": 0, "kernel": 0, "shapes": []}
    real_fn, real_kernel = port_attn.FlashAttentionFn.apply, port_attn.flash_attention

    def kernel(q, k, v, causal=True):
        calls["kernel"] += 1
        calls["shapes"].append((q.shape[1], k.shape[1], causal))
        return real_kernel(q, k, v, causal=causal)

    monkeypatch.setattr(port_attn.FlashAttentionFn, "apply",
                        lambda *a: calls.update(fn=calls["fn"] + 1) or real_fn(*a))
    monkeypatch.setattr(port_attn, "flash_attention", kernel)
    cfg = dataclasses.replace(port_registry.smoke_config("whisper-large-v3"), dtype="float32")
    params = port_lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (B, 8))
    frames = torch.randn(B, S_ENC, cfg.d_model) * 0.02
    n = cfg.n_enc_layers + 2 * cfg.n_layers
    with torch.no_grad():
        port_lm.forward(params, cfg, tokens, frames=frames)
    assert calls["fn"] == 0 and calls["kernel"] == n
    assert sorted(set(calls["shapes"])) == [(8, 8, True), (8, S_ENC, False),
                                            (S_ENC, S_ENC, False)]
    port_lm.forward(port_lm.tree_map(lambda a: a.requires_grad_(True), params), cfg, tokens,
                    frames=frames)
    assert calls["fn"] == n and calls["kernel"] == 2 * n
    with torch.no_grad():
        cross_kv = port_lm.encoder_forward(params, cfg, frames)
        calls.update(kernel=0, shapes=[])
        state = port_lm.init_decode_state(cfg, B, 4, cross_kv=cross_kv, device="cpu")
        port_lm.decode_step(params, cfg, tokens[:, :1], state)
    assert calls["kernel"] == cfg.n_layers and set(calls["shapes"]) == {(1, S_ENC, False)}


# --------------------------------------------------------------------------
# the encoder, forward, prefill
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_forward_matches_reference(ref, case, dtype):
    c = case("whisper-large-v3", dtype)
    want = ref.jax.jit(lambda p, f: ref.lm.encoder_forward(p, c.cfg, f))(
        c.params, c.extras["frames"])
    got = port_lm.encoder_forward(c.pparams, c.pcfg, c.pextras["frames"])
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S_ENC, c.cfg.d_model)
    close(got, f32(want), REL_FP32 if dtype == "float32" else REL_BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(ref, case, arch):
    c = case(arch)
    want, want_aux = ref.jax.jit(lambda p, t, e: ref.lm.forward(p, c.cfg, t, **e))(
        c.params, c.tokens[:, :-1], c.extras)
    got, aux = port_lm.forward(c.pparams, c.pcfg, c.ptokens[:, :-1], **c.pextras)
    assert got.shape == (B, S + c.cfg.n_img_tokens, c.cfg.d_model)
    close(got, want, REL_FP32)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(ref, case, arch, dtype):
    c = case(arch, dtype)
    want = ref.jax.jit(ref.steps.make_prefill_step(c.cfg))(
        c.params, dict(tokens=c.tokens[:, :-1], **c.extras))
    got = port_steps.make_prefill_step(c.pcfg)(
        c.pparams, dict(tokens=c.ptokens[:, :-1], **c.pextras))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, c.cfg.vocab_padded)
    close(got, f32(want), REL_FP32 if dtype == "float32" else REL_BF16)


def test_image_prefix_moves_the_text_logits(case):
    """pixtral's text positions attend to the image prefix: other image
    embeddings give other last logits, and none gives a stream of S."""
    c = case("pixtral-12b")
    prefill = port_steps.make_prefill_step(c.pcfg)
    tokens = c.ptokens[:, :-1]
    with_img = prefill(c.pparams, dict(tokens=tokens, **c.pextras))
    other = prefill(c.pparams, dict(tokens=tokens, img_embeds=-c.pextras["img_embeds"]))
    text_only = prefill(c.pparams, {"tokens": tokens})
    assert float((with_img - other).abs().max()) > 1e-3
    assert float((with_img - text_only).abs().max()) > 1e-3
    hidden, _ = port_lm.forward(c.pparams, c.pcfg, tokens)
    assert hidden.shape == (B, S, c.cfg.d_model)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def _whisper_decode(ref, c, n, max_len=S):
    """The reference's and the port's decode logits of c.tokens[:, :n]
    against the encoder's output of c's frames."""
    cross = ref.lm.encoder_forward(c.params, c.cfg, c.extras["frames"])
    decode = ref.jax.jit(ref.steps.make_decode_step(c.cfg))
    state = ref.lm.init_decode_state(c.cfg, B, max_len, cross_kv=cross)
    want = []
    for i in range(n):
        logits, state = decode(c.params, c.tokens[:, i:i + 1], state)
        want.append(f32(logits))
    pcross = port_lm.encoder_forward(c.pparams, c.pcfg, c.pextras["frames"])
    pdecode = port_steps.make_decode_step(c.pcfg)
    pstate = port_lm.init_decode_state(c.pcfg, B, max_len, cross_kv=pcross, device="cpu")
    got = []
    for i in range(n):
        logits, pstate = pdecode(c.pparams, c.ptokens[:, i:i + 1], pstate)
        got.append(logits)
    return want, got, pstate


def test_whisper_decode_logits_match_reference(ref, case):
    c = case("whisper-large-v3")
    want, got, state = _whisper_decode(ref, c, DECODE_STEPS)
    for g, w in zip(got, want):
        close(g, w, REL_FP32)
    assert [int(seg.length.max()) for seg in state.segments] == [DECODE_STEPS]
    assert state.cross_kv.shape == (B, S_ENC, c.cfg.d_model)


def test_whisper_decode_disagrees_with_prefill_as_the_reference_does(ref, case):
    """The reference's fault, kept: its decode embeds each token without the
    sinusoidal position its prefill adds, so after the same 8 tokens and
    frames the two disagree.  The port's decode equals the reference's
    (1e-5), its prefill the reference's prefill (1e-5), and on both sides
    decode and prefill differ by more than 0.1 (max abs)."""
    c = case("whisper-large-v3")
    n = 8
    want, got, _ = _whisper_decode(ref, c, n)
    for g, w in zip(got, want):
        close(g, w, REL_FP32)
    want_prefill = f32(ref.jax.jit(ref.steps.make_prefill_step(c.cfg))(
        c.params, dict(tokens=c.tokens[:, :n], **c.extras)))
    got_prefill = port_steps.make_prefill_step(c.pcfg)(
        c.pparams, dict(tokens=c.ptokens[:, :n], **c.pextras))
    close(got_prefill, want_prefill, REL_FP32)
    assert float(np.abs(want[-1] - want_prefill).max()) > 0.1
    assert float((got[-1] - got_prefill).abs().max()) > 0.1


def test_pixtral_decode_logits_match_reference(ref, case):
    c = case("pixtral-12b")
    decode = ref.jax.jit(ref.steps.make_decode_step(c.cfg))
    state = ref.lm.init_decode_state(c.cfg, B, S)
    pdecode = port_steps.make_decode_step(c.pcfg)
    pstate = port_lm.init_decode_state(c.pcfg, B, S, device="cpu")
    for i in range(DECODE_STEPS):
        want, state = decode(c.params, c.tokens[:, i:i + 1], state)
        got, pstate = pdecode(c.pparams, c.ptokens[:, i:i + 1], pstate)
        close(got, f32(want), REL_FP32)
    assert pstate.cross_kv is None


def test_pixtral_greedy_tokens_equal_reference(ref, case):
    c = case("pixtral-12b")
    prompt = c.tokens[:, :6]
    want = ref.steps.greedy_generate(c.params, c.cfg, ref.jnp.asarray(prompt), 6, 16)
    got = port_steps.greedy_generate(c.pparams, c.pcfg, torch.as_tensor(prompt).long(), 6, 16)
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_whisper_decode():
    """Mirror of tests/test_arch_smoke.py::test_whisper_decode: the SMOKE
    config from a seed, 64 frames through the encoder, one decode step."""
    cfg = port_registry.smoke_config("whisper_large_v3")
    gen = torch.Generator().manual_seed(0)
    params = port_lm.init_params(gen, cfg, device="cpu")
    frames = torch.randn(B, 64, cfg.d_model, generator=gen) * 0.02
    cross_kv = port_lm.encoder_forward(params, cfg, frames)
    state = port_lm.init_decode_state(cfg, B, max_len=16, cross_kv=cross_kv, device="cpu")
    logits, state = port_steps.make_decode_step(cfg)(params, torch.zeros((B, 1), dtype=torch.int64),
                                                     state)
    assert logits.shape == (B, cfg.vocab_padded)
    assert bool(torch.isfinite(logits.float()).all())


def test_encoder_decoder_inputs_are_required(case):
    """What the reference leaves to an assert or a broadcast error, the port
    raises as ValueError naming the missing input."""
    c = case("whisper-large-v3")
    with pytest.raises(ValueError, match="frames"):
        port_lm.forward(c.pparams, c.pcfg, c.ptokens)
    state = port_lm.init_decode_state(c.pcfg, B, 4, device="cpu")
    with pytest.raises(ValueError, match="cross_kv=encoder_forward"):
        port_lm.decode_step(c.pparams, c.pcfg, c.ptokens[:, :1], state)
    with pytest.raises(ValueError, match="greedy_generate has no frames"):
        port_steps.greedy_generate(c.pparams, c.pcfg, c.ptokens[:, :2], 2, 8)


# --------------------------------------------------------------------------
# loss_fn, its gradient, a train step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_gradients_match_reference(ref, case, arch):
    """loss_fn and every gradient leaf against jax.grad (loss 1e-5, leaves
    1e-4), in float32; the encoder's, the cross layers' and the image
    path's leaves included.  Under remat (the SMOKE configs' default) the
    cross layer sits in its layer's checkpoint."""
    c = case(arch)
    assert c.cfg.remat
    (_, want_m), want_g = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: ref.steps.loss_fn(p, c.cfg, b), has_aux=True))(
            c.params, dict(tokens=c.tokens, **c.extras))
    metrics, grads = port_steps.grads_of(c.pparams, c.pcfg, dict(tokens=c.ptokens, **c.pextras))
    close(metrics["loss"], want_m["loss"], 1e-5, "loss")
    assert float(metrics["acc"]) == pytest.approx(float(want_m["acc"]), abs=1e-6)
    it = iter(grads)
    gtree = port_lm.tree_map(lambda _: next(it), c.pparams)
    paths = list(_paths(ref.jax.tree.map(np.asarray, want_g)))
    for path, want in paths:
        close(_get(gtree, path), want, 1e-4, f"grad {path}")
    if c.cfg.is_encdec:
        assert {"encoder", "cross"} <= {p[0] for p, _ in paths}


def test_pixtral_text_only_loss_raises_where_the_reference_fails(ref, case):
    """The reference's loss_fn cuts n_img_tokens (8) positions off the hidden
    states whether or not an image was given.  A text-only batch of 32
    inputs then fails on a shape mismatch in its chunked loss (24 hidden
    positions against 32 targets, a ragged last chunk of 8 against 16); one
    of 16 inputs gives a finite loss of hidden positions 8-15 against targets
    0-7.  The port raises ValueError naming img_embeds for both."""
    c = case("pixtral-12b")
    long = np.random.default_rng(4).integers(0, c.cfg.vocab, (B, 33)).astype(np.int32)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        ref.steps.loss_fn(c.params, c.cfg, {"tokens": long})
    assert np.isfinite(float(ref.steps.loss_fn(c.params, c.cfg, {"tokens": c.tokens})[0]))
    for tokens in (torch.as_tensor(long).long(), c.ptokens):
        with pytest.raises(ValueError, match="img_embeds"):
            port_steps.loss_fn(c.pparams, c.pcfg, {"tokens": tokens})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    """Mirror of tests/test_arch_smoke.py::test_forward_and_train_step for
    the two configs: the SMOKE config from a seed, a forward of 32 tokens
    (and the image prefix), one train step: finite, near log(vocab), the
    parameters moved."""
    cfg = port_registry.smoke_config(arch)
    opt_cfg = port_adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    gen = torch.Generator().manual_seed(0)
    state = port_steps.init_train_state(gen, cfg, opt_cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, 33), generator=gen)}
    batch.update({k: torch.as_tensor(v) for k, v in extras(cfg, 3).items()})
    inputs = {k: v for k, v in batch.items() if k != "tokens"}
    hidden, aux = port_lm.forward(state.params, cfg, batch["tokens"][:, :-1], **inputs)
    assert hidden.shape == (B, 32 + cfg.n_img_tokens, cfg.d_model)
    assert bool(torch.isfinite(hidden.float()).all()) and float(aux) == 0.0
    first = state.params["embed"]["table"].clone()
    state, metrics = port_steps.make_train_step(cfg, opt_cfg)(state, batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert 0 < float(metrics["loss"]) < np.log(cfg.vocab) + 2.0
    assert not torch.allclose(first, state.params["embed"]["table"])


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash attention kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_flash_function_gradients_on_card(cuda_device, dtype):
    """FlashAttentionFn non-causal at Whisper's cross shape (Sq = 448 against
    Sk = 1500, 20 heads of 64) on the card: the forward is the kernel (its
    counter moves), the gradients autograd through _attend_chunked on the
    same inputs, at the flash tolerances (float32 2e-5, bf16 2^-8 + 1e-4)."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, 448, 20, 64, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(2, 1500, 20, 64, generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    dout = torch.randn(2, 448, 20, 64, generator=g, device=cuda_device).to(dtype)
    kernel = getattr(ops, f"flash_attention_{ops.kernel_for(dtype, 64)}")
    before = kernel.launches
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(port_attn.FlashAttentionFn.apply(*leaves, 256, False), leaves,
                              dout)
    assert kernel.launches == before + 1
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(port_attn._attend_chunked(*plain, causal=False, chunk=256),
                               plain, dout)
    tol = 2e-5 if dtype == torch.float32 else 2**-8 + 1e-4
    for a, b in zip(got, want):
        assert a.dtype == dtype
        close(a.float(), b.float().cpu().numpy(), tol)


@pytest.mark.gpu
def test_whisper_runs_every_attention_on_the_kernel_on_card(cuda_device):
    """Whisper widened to head 64 (bf16: the wgmma kernel) on the card: a
    prefill launches it n_enc_layers + 2 n_layers times (encoder,
    decoder, cross), a decode step n_layers times (the cross-attention at
    Sq = 1); the logits are finite."""
    from repro_torch.kernels.flash_attention import ops

    cfg = dataclasses.replace(port_registry.smoke_config("whisper-large-v3"), d_model=256)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = port_lm.init_params(gen, cfg, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab, (B, 12), generator=gen, device=cuda_device)
    frames = torch.randn(B, 100, cfg.d_model, generator=gen, device=cuda_device) * 0.02
    before = ops.flash_attention_sm90.launches
    logits = port_steps.make_prefill_step(cfg)(params, {"tokens": tokens, "frames": frames})
    assert ops.flash_attention_sm90.launches - before == cfg.n_enc_layers + 2 * cfg.n_layers
    with torch.no_grad():
        cross = port_lm.encoder_forward(params, cfg, frames)
    state = port_lm.init_decode_state(cfg, B, 4, cross_kv=cross, device=cuda_device)
    before = ops.flash_attention_sm90.launches
    step, _ = port_steps.make_decode_step(cfg)(params, tokens[:, :1], state)
    assert ops.flash_attention_sm90.launches - before == cfg.n_layers
    assert bool(torch.isfinite(logits.float()).all()) and bool(torch.isfinite(step.float()).all())
