"""The port's training slice (losses, AdamW, TrainState, the train step) against the reference.

Inputs are built by ``repro`` from a PRNG key or by numpy from a seed and
handed across as numpy arrays (parameters through
``repro_torch.interop.lm_params_from_numpy`` / ``train_state_from_numpy``),
so both packages compute on the same numbers.  All comparisons run in
float32 (the SMOKE configs' compute dtype replaced by float32 on both
sides), where the port's prefill attention on the CPU is the flash kernel's
plain version and its gradient the plain ``_attend_chunked``'s
(``models.attention.FlashAttentionFn``); the reference trains through
``_attend_chunked``.

Tolerances, relative to the largest reference magnitude: 1e-6 for the loss
head and the optimizer (the same float32 operations, sums in another
order); 1e-5 for ``loss_fn``'s loss and aux (a whole forward: attention by
another algorithm, sums in another order); 1e-4 per gradient leaf, norm-
relative (a whole backward, with the same sums' reorderings, through a
small leaf's few reductions); 1e-4 for the loss of three train steps (three
updates compound the gradient's 1e-4); 1e-5 between 1 and 2 microbatches
(the same arithmetic but the split reductions).  The ``gpu`` tests run the
flash kernel's Function and one train step on the card.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as port_registry
from repro_torch.interop import lm_params_from_numpy, train_state_from_numpy
from repro_torch.models import attention as port_attn
from repro_torch.models import lm as port_lm
from repro_torch.models import losses as port_losses
from repro_torch.models import steps as port_steps
from repro_torch.models.config import count_params
from repro_torch.optim import adamw as port_adamw

MOE = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]
ARCHS = ["minitron-4b", "codeqwen1.5-7b", "gemma-7b", "granite-34b", *MOE, "zamba2-1.2b",
         "xlstm-350m"]
B, S = 2, 24


@pytest.fixture(scope="module")
def ref():
    """The reference's training stack, loaded in a fixture so that the file
    imports on a card machine that has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.models import lm, losses, steps
    from repro.optim import adamw

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, registry=registry, lm=lm,
                                 losses=losses, steps=steps, adamw=adamw)


def rel_err(got, want) -> float:
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def close(got, want, rel, what=""):
    err = rel_err(got, want)
    assert err <= rel, f"{what}: norm-relative error {err:.3e} > {rel:.0e}"


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


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", **kw)


@pytest.fixture(scope="module")
def case(ref):
    """arch -> the reference's float32 SMOKE config, parameters and batch,
    and the port's carried copies; each built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = _f32(ref.registry.smoke_config(arch))
            pcfg = _f32(port_registry.smoke_config(arch))
            params = ref.lm.init_params(ref.jax.random.PRNGKey(0), cfg)
            tree = ref.jax.tree.map(np.asarray, params)
            tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
            built[arch] = types.SimpleNamespace(
                cfg=cfg, pcfg=pcfg, params=params, tree=tree,
                pparams=lm_params_from_numpy(tree, pcfg, "cpu"), tokens=tokens,
                ptokens=torch.as_tensor(tokens, dtype=torch.int64))
        return built[arch]

    return get


# --------------------------------------------------------------------------
# the loss head
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw,s", [
    ("minitron-4b", {}, 40),  # loss_chunk 16: two chunks and a ragged 8
    ("gemma-7b", dict(logit_softcap=30.0), 32),  # tied embeddings, gemma's softcap
    ("codeqwen1.5-7b", dict(vocab=500), 20),  # vocab padded to 512, masked
], ids=["ragged", "softcap", "padded-vocab"])
def test_chunked_cross_entropy_matches_reference(ref, arch, kw, s):
    cfg = _f32(ref.registry.smoke_config(arch), **kw)
    pcfg = _f32(port_registry.smoke_config(arch), **kw)
    assert (cfg.vocab_padded != cfg.vocab) == ("vocab" in kw)
    params = ref.jax.tree.map(np.asarray, ref.lm.init_params(ref.jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    want_fn = lambda h: ref.losses.chunked_cross_entropy(params, cfg, h, targets)
    want_nll, want_acc = want_fn(hidden)
    want_dh = ref.jax.grad(lambda h: want_fn(h)[0])(hidden)
    pparams = lm_params_from_numpy(params, pcfg, "cpu")
    h = torch.as_tensor(hidden).requires_grad_(True)
    nll, acc = port_losses.chunked_cross_entropy(pparams, pcfg, h, torch.as_tensor(targets).long())
    (dh,) = torch.autograd.grad(nll, h)
    close(nll, want_nll, 1e-6, "nll")
    assert float(acc) == float(want_acc)
    close(dh, want_dh, 1e-6, "d nll / d hidden")
    assert nll.dtype == acc.dtype == torch.float32


def test_chunked_cross_entropy_keeps_one_chunk_of_logits():
    """Under grad, each whole chunk runs under a checkpoint: the graph keeps
    no (B, chunk, V) logit block, so the saved tensors do not grow with S."""
    cfg = _f32(port_registry.smoke_config("minitron-4b"))
    params = port_lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def saved_numel(s):
        h = torch.randn(B, s, cfg.d_model, requires_grad=True)
        t = torch.randint(0, cfg.vocab, (B, s))
        sizes = []
        with torch.autograd.graph.saved_tensors_hooks(lambda x: sizes.append(x.numel()) or x,
                                                      lambda x: x):
            port_losses.chunked_cross_entropy(params, cfg, h, t)
        return max(sizes)

    assert saved_numel(64) == saved_numel(16) < B * 16 * cfg.vocab_padded


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def test_schedule_matches_reference(ref):
    cfg = port_adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=7, total_steps=40)
    rcfg = ref.adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=7, total_steps=40)
    steps = np.arange(0, 41, dtype=np.int32)
    want = np.asarray(ref.adamw.schedule(rcfg, ref.jnp.asarray(steps)))
    got = port_adamw.schedule(cfg, torch.as_tensor(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(got[7]) == pytest.approx(1e-3) and float(got[40]) == pytest.approx(1e-4)


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    draw = lambda s: rng.standard_normal(s).astype(np.float32)
    params = {"a": draw((5, 3)), "b": {"c": draw((7,)), "d": draw((2, 2, 4))}, "bias": draw((4,))}
    grads = {"a": draw((5, 3)) * 3, "b": {"c": draw((7,)), "d": draw((2, 2, 4))},
             "bias": np.zeros(4, np.float32)}
    mu = {"a": draw((5, 3)) * 0.1, "b": {"c": draw((7,)) * 0.1, "d": draw((2, 2, 4)) * 0.1},
          "bias": draw((4,)) * 0.1}
    nu = {"a": draw((5, 3)) ** 2, "b": {"c": draw((7,)) ** 2, "d": draw((2, 2, 4)) ** 2},
          "bias": draw((4,)) ** 2}
    return params, grads, mu, nu


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(ref, moment_dtype):
    """Two clipped updates (the first grads' norm ~7 > clip 1) from a
    non-zero state; ``bias``'s gradient is ``None`` on the port's side and
    zeros on the reference's: its weight decay moves it all the same."""
    kw = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10, moment_dtype=moment_dtype)
    cfg, rcfg = port_adamw.AdamWConfig(**kw), ref.adamw.AdamWConfig(**kw)
    params, grads, mu, nu = _opt_inputs(5)
    jnp = ref.jnp
    mdt = jnp.dtype(moment_dtype)
    rstate = ref.adamw.AdamWState(mu=ref.jax.tree.map(lambda a: jnp.asarray(a, mdt), mu),
                                  nu=ref.jax.tree.map(lambda a: jnp.asarray(a, mdt), nu),
                                  count=jnp.asarray(3, jnp.int32))
    rparams = ref.jax.tree.map(jnp.asarray, params)
    to_t = lambda tree, dt=torch.float32: port_lm.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)).to(dt), tree)
    mt = getattr(torch, moment_dtype)
    pstate = port_adamw.AdamWState(mu=to_t(mu, mt), nu=to_t(nu, mt),
                                   count=torch.tensor(3, dtype=torch.int32))
    pparams = to_t(params)
    pgrads = dict(to_t(grads), bias=None)
    for _ in range(2):
        rparams, rstate, rmetrics = ref.adamw.update(rparams, ref.jax.tree.map(jnp.asarray, grads),
                                                     rstate, rcfg)
        pparams, pstate, pmetrics = port_adamw.update(pparams, pgrads, pstate, cfg)
    for path, want in _paths(ref.jax.tree.map(np.asarray, rparams)):
        close(_get(pparams, path), want, 1e-6, f"params {path}")
    for field in ("mu", "nu"):
        for path, want in _paths(ref.jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                  getattr(rstate, field))):
            got = _get(getattr(pstate, field), path)
            assert got.dtype == mt
            close(got, want, 1e-6 if moment_dtype == "float32" else 2**-8, f"{field} {path}")
    assert int(pstate.count) == int(rstate.count) == 5 and pstate.count.dtype == torch.int32
    close(pmetrics["grad_norm"], rmetrics["grad_norm"], 1e-6, "grad_norm")
    close(pmetrics["lr"], rmetrics["lr"], 1e-6, "lr")
    assert not np.allclose(pparams["bias"].numpy(), params["bias"])  # decayed, no gradient


def test_adamw_updates_in_place_and_bumps_version():
    params = {"w": torch.ones(3), "v": torch.ones(2)}
    state = port_adamw.init(params, port_adamw.AdamWConfig())
    w, mu, version = params["w"], state.mu["w"], params["w"]._version
    new, new_state, _ = port_adamw.update(params, {"w": torch.ones(3), "v": None}, state,
                                          port_adamw.AdamWConfig(warmup_steps=0))
    assert new["w"] is w and new_state.mu["w"] is mu and w._version > version
    assert float(w[0]) < 1.0 and int(new_state.count) == 1 and int(state.count) == 0
    assert port_adamw.global_norm({"a": torch.full((4,), 2.0), "b": None}) == 4.0


# --------------------------------------------------------------------------
# the flash kernel's Function
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk,h,kh", [(40, 16, 4, 2), (16, 32, 2, 2)],
                         ids=["three-tiles", "one-tile"])
def test_flash_function_gradient_is_the_plain_functions(s, chunk, h, kh):
    """FlashAttentionFn's forward is the kernel's function (on the CPU its
    plain version) and its q, k, v gradients are autograd through
    _attend_chunked, one query tile at a time: the same float32 operations,
    dk and dv summed over the tiles in another order (1e-6)."""
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(2, s, n, 32, generator=g) for n in (h, kh, kh))
    dout = torch.randn(2, s, h, 32, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = port_attn.FlashAttentionFn.apply(*leaves, chunk)
    assert torch.equal(out, port_attn.flash_attention(q, k, v, causal=True))
    got = torch.autograd.grad(out, leaves, dout)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = port_attn._attend_chunked(*plain, causal=True, chunk=chunk)
    want = torch.autograd.grad(want_out, plain, dout)
    close(out, want_out.detach().numpy(), 1e-6, "out")
    for name, a, b in zip("qkv", got, want):
        close(a, b.numpy(), 1e-6, f"d{name}")


def test_gqa_forward_routes_by_requires_grad(monkeypatch):
    """With grad the Function, without it the bare kernel function, at a
    full head (128) and at the SMOKE config's own (8); a sliding window
    takes _attend_chunked."""
    calls = {"fn": 0, "kernel": 0}
    real_fn, real_kernel = port_attn.FlashAttentionFn.apply, port_attn.flash_attention
    monkeypatch.setattr(port_attn.FlashAttentionFn, "apply",
                        lambda *a: calls.update(fn=calls["fn"] + 1) or real_fn(*a))
    monkeypatch.setattr(port_attn, "flash_attention",
                        lambda *a, **k: calls.update(kernel=calls["kernel"] + 1)
                        or real_kernel(*a, **k))
    smoke = _f32(port_registry.smoke_config("minitron-4b"))
    for cfg, routed in ((dataclasses.replace(smoke, d_model=512, n_heads=4), True),
                        (smoke, True), (dataclasses.replace(smoke, sliding_window=4), False)):
        calls.update(fn=0, kernel=0)
        params = port_lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        tokens = torch.randint(0, cfg.vocab, (B, 8))
        with torch.no_grad():
            port_lm.forward(params, cfg, tokens)
        assert calls == {"fn": 0, "kernel": cfg.n_layers * routed}
        port_lm.forward(port_lm.tree_map(lambda a: a.requires_grad_(True), params), cfg, tokens)
        assert calls == {"fn": cfg.n_layers * routed, "kernel": 2 * cfg.n_layers * routed}


# --------------------------------------------------------------------------
# loss_fn, its gradient, the train step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_gradients_match_reference(ref, case, arch):
    c = case(arch)
    (want_total, want_m), want_g = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, t: ref.steps.loss_fn(p, c.cfg, {"tokens": t}), has_aux=True))(c.params, c.tokens)
    metrics, grads = port_steps.grads_of(c.pparams, c.pcfg, {"tokens": c.ptokens})
    close(metrics["loss"], want_m["loss"], 1e-5, "loss")
    close(metrics["aux"], want_m["aux"], 1e-5, "aux")
    assert float(metrics["acc"]) == pytest.approx(float(want_m["acc"]), abs=1e-6)
    assert (float(want_m["aux"]) > 0) == (arch in MOE)
    it = iter(grads)
    gtree = port_lm.tree_map(lambda _: next(it), c.pparams)
    n = 0
    for path, want in _paths(ref.jax.tree.map(np.asarray, want_g)):
        got = _get(gtree, path)
        if path[-1] == "router_bias":  # reaches the loss only through topk's indices
            assert got is None and not np.any(want)
            continue
        close(got, want, 1e-4, f"grad {path}")
        n += 1
    assert n == len(list(_paths(want_g))) - (arch in MOE)


@pytest.mark.parametrize("arch", ["minitron-4b", "moonshot-v1-16b-a3b"])
def test_train_steps_match_reference(ref, case, arch):
    """Three steps of make_train_step from the reference's initial state,
    with 1 and 2 microbatches, each against the reference's with as many:
    the losses within 1e-4.  The dense model's 2 microbatches equal its 1
    within 1e-5; the MoE model's do not, on either side: each microbatch
    routes its own tokens under its own capacity, so other choices drop."""
    c = case(arch)
    kw = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    rcfg, pcfg = ref.adamw.AdamWConfig(**kw), port_adamw.AdamWConfig(**kw)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, c.cfg.vocab, (4, S + 1)).astype(np.int32) for _ in range(3)]
    want, got = {}, {}
    for micro in (1, 2):
        rstate = ref.steps.init_train_state(ref.jax.random.PRNGKey(0), c.cfg, rcfg)
        state = train_state_from_numpy(ref.jax.tree.map(np.asarray, rstate), c.pcfg, "cpu")
        rstep = ref.jax.jit(ref.steps.make_train_step(c.cfg, rcfg, microbatches=micro))
        step = port_steps.make_train_step(c.pcfg, pcfg, microbatches=micro)
        want[micro], got[micro] = [], []
        for t in batches:
            rstate, m = rstep(rstate, {"tokens": t})
            want[micro].append({k: float(v) for k, v in m.items()})
            state, m = step(state, {"tokens": torch.as_tensor(t).long()})
            got[micro].append({k: float(v) for k, v in m.items()})
        assert int(state.step) == 3 and int(state.opt.count) == 3
        for w, g in zip(want[micro], got[micro]):
            assert g["step"] == w["step"] and g["lr"] == pytest.approx(w["lr"], rel=1e-6)
            assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    dense = arch != "moonshot-v1-16b-a3b"
    for side in (got, want):
        same = all(g2[k] == pytest.approx(g1[k], rel=1e-5, abs=1e-7)
                   for g1, g2 in zip(side[1], side[2]) for k in ("loss", "aux", "grad_norm"))
        assert same == dense


@pytest.mark.parametrize("arch", ["minitron-4b", "moonshot-v1-16b-a3b"])
def test_eval_step_matches_loss_fn(case, arch):
    c = case(arch)
    m = port_steps.make_eval_step(c.pcfg)(c.pparams, {"tokens": c.ptokens})
    _, want = port_steps.loss_fn(c.pparams, c.pcfg, {"tokens": c.ptokens})
    assert all(float(m[k]) == float(want[k]) for k in ("loss", "acc", "aux"))
    assert not m["loss"].requires_grad


# --------------------------------------------------------------------------
# mirrors of tests/test_arch_smoke.py (whisper's and pixtral's forward and
# train step, which take frames and image embeddings, are in
# tests/test_torch_encdec.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    cfg = port_registry.smoke_config(arch)
    opt_cfg = port_adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    state = port_steps.init_train_state(torch.Generator().manual_seed(0), cfg, opt_cfg,
                                        device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 33), generator=torch.Generator().manual_seed(1))
    hidden, aux = port_lm.forward(state.params, cfg, tokens[:, :-1])
    assert hidden.shape == (2, 32, cfg.d_model)
    assert bool(torch.isfinite(hidden.float()).all()) and bool(torch.isfinite(aux))
    first = state.params["embed"]["table"].clone()
    state, metrics = port_steps.make_train_step(cfg, opt_cfg)(state, {"tokens": tokens})
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert 0 < float(metrics["loss"]) < np.log(cfg.vocab) + 2.0
    assert not torch.allclose(first, state.params["embed"]["table"])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["minitron-4b", "moonshot-v1-16b-a3b"])
def test_train_step_is_its_two_halves(arch, microbatches):
    """``train_step.gradient`` then ``train_step.apply`` (the halves a caller
    times apart) give the step's own state and metrics, bit for bit."""
    cfg = port_registry.smoke_config(arch)
    opt_cfg = port_adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    train_step = port_steps.make_train_step(cfg, opt_cfg, microbatches=microbatches)
    tokens = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1))
    whole, halves = (port_steps.init_train_state(torch.Generator().manual_seed(0), cfg, opt_cfg,
                                                 device="cpu") for _ in range(2))
    whole, want = train_step(whole, {"tokens": tokens})
    halves, got = train_step.apply(halves, *train_step.gradient(halves, {"tokens": tokens}))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    for a, b in zip(port_lm.tree_leaves(halves), port_lm.tree_leaves(whole)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(arch):
    cfg = port_registry.smoke_config(arch)
    params = port_lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = port_lm.init_decode_state(cfg, 2, max_len=16, device="cpu")
    decode = port_steps.make_decode_step(cfg)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    for _ in range(3):
        logits, state = decode(params, tok, state)
        assert logits.shape == (2, cfg.vocab_padded)
        assert bool(torch.isfinite(logits.float()).all())
        tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None]


@pytest.mark.parametrize("arch", ARCHS + ["pixtral-12b", "whisper-large-v3"])
def test_param_counts_positive(arch):
    counts = count_params(port_registry.full_config(arch))
    assert counts["total"] > 0
    assert 0 < counts["active"] <= counts["total"]


# The SMOKE configs widened to head_dim 64, so that the card runs the bf16
# wgmma kernel (row 9a) in every attention that has one; deepseek-v3's MLA and
# xlstm-350m have none (MLA is plain code, as the reference's) and stay as
# they are.
LEAF_WIDTHS = {
    "minitron-4b": dict(d_model=256, n_heads=4, n_kv_heads=2),
    "moonshot-v1-16b-a3b": dict(d_model=256, n_heads=4, n_kv_heads=4),
    "deepseek-v3-671b": {},
    "zamba2-1.2b": dict(d_model=256, n_heads=4, n_kv_heads=4),
    "xlstm-350m": {},
    "whisper-large-v3": dict(d_model=256, n_heads=4, n_kv_heads=4),
    "pixtral-12b": dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64),
}


@pytest.mark.parametrize("arch", list(LEAF_WIDTHS))
def test_every_leaf_but_router_bias_gets_a_gradient(arch):
    _every_leaf_gets_a_gradient(arch, "cpu")


def _leaf_config(arch):
    return dataclasses.replace(port_registry.smoke_config(arch), **LEAF_WIDTHS[arch])


def _attention_calls(cfg) -> int:
    """The flash attentions one forward of ``cfg`` runs: zamba2's shared
    block once an invocation, whisper's encoder, decoder and cross layers,
    one a layer otherwise; none for MLA and xLSTM."""
    if cfg.attn_type == "mla" or cfg.block_type == "xlstm":
        return 0
    if cfg.block_type == "mamba2":
        return port_lm.shared_invocations(cfg)
    return cfg.n_enc_layers + 2 * cfg.n_layers if cfg.is_encdec else cfg.n_layers


def _every_leaf_gets_a_gradient(arch, device):
    """One train step's gradient: every leaf but ``router_bias`` non-None and
    non-zero; whisper's batch holds 24 frames, pixtral's its image
    embeddings.  ``router_bias`` (deepseek-v3, moonshot) reaches the loss
    only through topk's indices, so it has no gradient in the reference
    either.  zamba2's shared block is one set of weights reached from two
    invocations: its gradient is their sum.  The inputs (frames, image
    embeddings) are not leaves and are asked no gradient."""
    cfg = _leaf_config(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = port_lm.init_params(gen, cfg, device=device)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 65), generator=gen, device=device)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn(2, 24, cfg.d_model, generator=gen, device=device) * 0.02
    if cfg.n_img_tokens:
        batch["img_embeds"] = torch.randn(2, cfg.n_img_tokens, cfg.d_model, generator=gen,
                                          device=device) * 0.02
    _, grads = port_steps.grads_of(params, cfg, batch)
    it = iter(grads)
    missing = [path for path, g in _paths(port_lm.tree_map(lambda _: next(it), params))
               if path[-1] != "router_bias" and (g is None or not bool(g.abs().amax() > 0))]
    assert missing == []
    assert not any(v.requires_grad for v in batch.values())
    return grads


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash attention kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_on_card(cuda_device, dtype):
    """FlashAttentionFn on the card: the forward is the kernel (its counter
    moves), the q, k, v gradients are autograd through _attend_chunked on
    the same inputs, held at the flash tolerances (float32 2e-5, bf16
    2^-8 + 1e-4, chip_smoke.py's TOL_FLASH) as the recompute runs the same
    operations on both sides."""
    from repro_torch.kernels.flash_attention import ops

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 1000, n, 128, generator=g, device=cuda_device).to(dtype)
               for n in (8, 2, 2))
    dout = torch.randn(2, 1000, 8, 128, generator=g, device=cuda_device).to(dtype)
    kernel = getattr(ops, f"flash_attention_{ops.kernel_for(dtype, 128)}")
    before = kernel.launches
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(port_attn.FlashAttentionFn.apply(*leaves, 256), leaves,
                              dout)
    assert kernel.launches == before + 1
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(port_attn._attend_chunked(*plain, causal=True, chunk=256),
                               plain, dout)
    tol = 2e-5 if dtype == torch.float32 else 2**-8 + 1e-4
    for a, b in zip(got, want):
        assert a.dtype == dtype
        close(a.float(), b.float().cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(LEAF_WIDTHS))
def test_every_leaf_gets_a_gradient_on_card(cuda_device, arch):
    from repro_torch.kernels.flash_attention import ops

    before = ops.flash_attention_sm90.launches
    _every_leaf_gets_a_gradient(arch, cuda_device)
    calls = _attention_calls(_leaf_config(arch))
    assert ops.flash_attention_sm90.launches - before == 2 * calls  # remat: twice
