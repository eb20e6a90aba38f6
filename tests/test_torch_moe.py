"""The port's MoE layer (``repro_torch.models.moe``) and the MoE model against the reference.

Inputs are built by numpy from a seed or by ``repro`` from a PRNG key and
handed across as numpy arrays, in float32.  Routing is discontinuous, so
every comparison of routed outputs first asserts that no selection is a
near-tie: the gap between neighbouring sorted selection logits, down to
the (k+1)-th, must be above ``TIE_MARGIN`` (the two packages' router logits
differ by ~1e-7 in float32), so that a tie fails loudly instead of flipping
a choice by chance.  The dispatch, the experts and the combine are also
held with the routing pinned (both sides given the same ids and gates,
the reference's ``_routing`` replaced for the call), including drops.

Tolerances, relative to the largest reference magnitude: 1e-6 for one
layer (the same float32 products, sums in another order); 1e-5 through
the whole SMOKE model (as ``tests/test_torch_lm.py``); ids, greedy tokens
and slot assignments equal.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as port_registry
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import lm as port_lm
from repro_torch.models import moe as port_moe
from repro_torch.models import steps as port_steps

ARCH = "moonshot-v1-16b-a3b"
TIE_MARGIN = 1e-5
B, S = 2, 24


@pytest.fixture(scope="module")
def ref():
    """The reference's MoE stack, loaded in a fixture so that the file
    imports on a card machine that has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry
    from repro.models import lm, moe, steps

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, registry=registry, lm=lm, moe=moe,
                                 steps=steps)


def rel_err(got, want) -> float:
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def close(got, want, rel, what=""):
    err = rel_err(got, want)
    assert err <= rel, f"{what}: norm-relative error {err:.3e} > {rel:.0e}"


def _cfgs(ref, **kw):
    smoke = lambda reg: dataclasses.replace(reg.smoke_config(ARCH), dtype="float32", **kw)
    return smoke(ref.registry), smoke(port_registry)


def _layer_params(ref, cfg, seed=0, bias=None):
    p = ref.jax.tree.map(np.asarray, ref.moe.init_moe(ref.jax.random.PRNGKey(seed), cfg,
                                                      ref.jnp.float32))
    if bias is not None:
        p["router_bias"] = bias.astype(np.float32)
    return p, port_lm.tree_map(lambda a: torch.tensor(np.asarray(a)), p)


def _tie_gap(select: torch.Tensor, k: int) -> float:
    """The least gap between neighbouring sorted selection logits among a
    token's top k + 1: the margin by which its routing is decided."""
    top = torch.topk(select, min(k + 1, select.shape[-1]), dim=-1).values
    return float((top[..., :-1] - top[..., 1:]).min())


@pytest.fixture
def tie_guard(monkeypatch):
    """Wrap the port's _routing to record every call's selection margin."""
    gaps = []
    real = port_moe._routing

    def routing(params, cfg, x2d):
        logits = x2d.float() @ params["router"].float()
        select = logits + params["router_bias"] if cfg.router_aux_free_bias else logits
        gaps.append(_tie_gap(select.detach(), cfg.top_k))
        return real(params, cfg, x2d)

    monkeypatch.setattr(port_moe, "_routing", routing)
    return gaps


def _check_no_ties(gaps):
    assert gaps and min(gaps) > TIE_MARGIN, f"a near-tie in routing: margins {min(gaps):.2e}"


# --------------------------------------------------------------------------
# one layer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("aux_free", [True, False])
def test_routing_matches_reference(ref, aux_free):
    cfg, pcfg = _cfgs(ref, router_aux_free_bias=aux_free)
    bias = np.random.default_rng(1).standard_normal(cfg.n_experts) * 0.5
    p, pp = _layer_params(ref, cfg, bias=bias)
    x = np.random.default_rng(2).standard_normal((40, cfg.d_model)).astype(np.float32)
    idx, gates, aux = ref.moe._routing(p, cfg, ref.jnp.asarray(x))
    pidx, pgates, paux = port_moe._routing(pp, pcfg, torch.as_tensor(x))
    select = torch.as_tensor(x) @ pp["router"] + (pp["router_bias"] if aux_free else 0)
    assert _tie_gap(select, cfg.top_k) > TIE_MARGIN
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    close(pgates, gates, 1e-6, "gates")
    close(paux, aux, 1e-6, "aux")
    assert pgates.dtype == torch.float32 and paux.dtype == torch.float32
    if aux_free:  # the bias moved the selection: some choice differs from the logits' top k
        plain = torch.topk(select - pp["router_bias"], cfg.top_k, dim=-1).indices
        assert not torch.equal(plain, pidx)


def _pinned(ref, cfg, p, x, idx, gates, monkeypatch):
    """The reference's moe_ffn with its routing replaced by (idx, gates)."""
    jnp = ref.jnp
    monkeypatch.setattr(ref.moe, "_routing", lambda params, c, x2d: (
        jnp.asarray(idx), jnp.asarray(gates), jnp.zeros((), jnp.float32)))
    out, _ = ref.moe.moe_ffn(p, cfg, jnp.asarray(x)[None])
    return np.asarray(out)[0]


@pytest.mark.parametrize("skew", [False, True], ids=["no-drops", "drops"])
def test_expert_ffn_with_pinned_routing_matches_reference(ref, skew, monkeypatch):
    """The dispatch, the experts and the combine on the same ids and gates.
    Without ``skew`` each expert takes 10 choices under a capacity of 12;
    with it every token's first choice is expert 0, far over the capacity,
    so most of those choices drop to the scratch row."""
    cfg, pcfg = _cfgs(ref, n_shared_experts=0)
    p, pp = _layer_params(ref, cfg)
    rng = np.random.default_rng(3)
    t, k, e = 40, cfg.top_k, cfg.n_experts
    x = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    idx = rng.permutation(e)[(np.arange(t)[:, None] * k + np.arange(k)) % e].astype(np.int32)
    if skew:
        idx[:, 0] = 0
        idx[:, 1] = 1 + rng.integers(0, e - 1, t)
    gates = rng.random((t, k)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    slot, keep = port_moe.dispatch_slots(pcfg, torch.as_tensor(idx).long())
    cap = port_moe.capacity(pcfg, t)
    assert cap == max(1, int(cfg.capacity_factor * t * k / e)) == 12
    assert bool((~keep).any()) == skew
    assert bool((slot[~keep] == cap).all()) and bool((slot[keep] < cap).all())
    want = _pinned(ref, cfg, p, x, idx, gates, monkeypatch)
    got = port_moe.expert_ffn(pp, pcfg, torch.as_tensor(x), torch.as_tensor(idx).long(),
                              torch.as_tensor(gates))
    close(got, want, 1e-6, "expert_ffn")


def test_moe_ffn_matches_reference(ref, tie_guard):
    cfg, pcfg = _cfgs(ref)
    p, pp = _layer_params(ref, cfg, seed=4)
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    out, aux = ref.moe.moe_ffn(p, cfg, ref.jnp.asarray(x))
    pout, paux = port_moe.moe_ffn(pp, pcfg, torch.as_tensor(x))
    _check_no_ties(tie_guard)
    close(pout, out, 1e-6, "moe_ffn")
    close(paux, aux, 1e-6, "aux")


def test_moe_gradients_match_reference(ref):
    """d(sum(out * w) + aux)/d(every leaf): ``router_bias`` has none on the
    port's side and zeros on the reference's (it reaches the output only
    through topk's indices)."""
    cfg, pcfg = _cfgs(ref)
    p, pp = _layer_params(ref, cfg, seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def ref_loss(params):
        out, aux = ref.moe.moe_ffn(params, cfg, ref.jnp.asarray(x))
        return (out * w).sum() + aux

    want = ref.jax.grad(ref_loss)(ref.jax.tree.map(ref.jnp.asarray, p))
    leaves = port_lm.tree_map(lambda a: a.requires_grad_(True), pp)
    out, aux = port_moe.moe_ffn(leaves, pcfg, torch.as_tensor(x))
    flat = list(port_lm.tree_leaves(leaves))
    grads = dict(zip([id(t) for t in flat], torch.autograd.grad(
        (out * torch.as_tensor(w)).sum() + aux, flat, allow_unused=True)))
    for key in ("router", "w_gate", "w_up", "w_down"):
        close(grads[id(leaves[key])], want[key], 1e-5, key)
    for key in ("w_gate", "w_up", "w_down"):
        close(grads[id(leaves["shared"][key])], want["shared"][key], 1e-5, f"shared {key}")
    assert grads[id(leaves["router_bias"])] is None and not np.any(want["router_bias"])


def test_update_router_bias_matches_reference(ref):
    cfg, pcfg = _cfgs(ref)
    p, pp = _layer_params(ref, cfg)
    counts = np.random.default_rng(8).dirichlet(np.ones(cfg.n_experts)).astype(np.float32)
    want = ref.moe.update_router_bias(p, cfg, ref.jnp.asarray(counts), lr=1e-2)
    got = port_moe.update_router_bias(pp, pcfg, torch.as_tensor(counts), lr=1e-2)
    np.testing.assert_array_equal(got["router_bias"].numpy(), np.asarray(want["router_bias"]))
    assert got["router"] is pp["router"] and not bool(pp["router_bias"].any())


# --------------------------------------------------------------------------
# the MoE model: moonshot SMOKE
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model(ref):
    cfg, pcfg = _cfgs(ref)
    params = ref.lm.init_params(ref.jax.random.PRNGKey(0), cfg)
    tree = ref.jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return types.SimpleNamespace(cfg=cfg, pcfg=pcfg, params=params,
                                 pparams=lm_params_from_numpy(tree, pcfg, "cpu"), tokens=tokens,
                                 ptokens=torch.as_tensor(tokens, dtype=torch.int64))


def test_forward_matches_reference(ref, model, tie_guard):
    want, aux = ref.jax.jit(lambda p, t: ref.lm.forward(p, model.cfg, t))(model.params,
                                                                          model.tokens)
    got, paux = port_lm.forward(model.pparams, model.pcfg, model.ptokens)
    _check_no_ties(tie_guard)
    assert len(tie_guard) == model.cfg.n_layers - model.cfg.first_k_dense
    close(got, want, 1e-5, "hidden")
    close(paux, aux, 1e-5, "aux")


def test_decode_steps_match_reference(ref, model, tie_guard):
    """Each decode step routes the B tokens of that step alone: capacity
    max(1, int(1.25 * 2 * 2 / 8)) = 1 slot an expert, so colliding choices
    drop, on both sides."""
    decode = ref.jax.jit(ref.steps.make_decode_step(model.cfg))
    state = ref.lm.init_decode_state(model.cfg, B, S)
    pdecode = port_steps.make_decode_step(model.pcfg)
    pstate = port_lm.init_decode_state(model.pcfg, B, S, device="cpu")
    assert port_moe.capacity(model.pcfg, B) == 1
    for i in range(8):
        logits, state = decode(model.params, model.tokens[:, i:i + 1], state)
        plogits, pstate = pdecode(model.pparams, model.ptokens[:, i:i + 1], pstate)
        close(plogits, np.asarray(logits), 1e-5, f"decode step {i}")
    _check_no_ties(tie_guard)


def test_greedy_tokens_equal_reference(ref, model, tie_guard):
    prompt = model.tokens[:, :6]
    want = ref.steps.greedy_generate(model.params, model.cfg, ref.jnp.asarray(prompt), 6, 16)
    got = port_steps.greedy_generate(model.pparams, model.pcfg, torch.as_tensor(prompt).long(),
                                     6, 16)
    _check_no_ties(tie_guard)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_and_decode_disagree_as_the_reference_does(ref, model):
    """Prefill routes all B * S tokens under one capacity, decode B at a
    time under capacity 1: the two give other logits on both sides (so the
    dense models' prefill-against-decode check does not apply to MoE)."""
    pre = port_steps.make_prefill_step(model.pcfg)(model.pparams, {"tokens": model.ptokens})
    decode = port_steps.make_decode_step(model.pcfg)
    state = port_lm.init_decode_state(model.pcfg, B, S, device="cpu")
    for i in range(S):
        logits, state = decode(model.pparams, model.ptokens[:, i:i + 1], state)
    assert rel_err(logits, pre.numpy()) > 1e-3
    want_pre = ref.jax.jit(ref.steps.make_prefill_step(model.cfg))(model.params,
                                                                    {"tokens": model.tokens})
    close(pre, np.asarray(want_pre), 1e-5, "prefill")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_ffn_pinned_on_card_matches_cpu(cuda_device, dtype):
    """expert_ffn on the card against the CPU on the same ids and gates,
    with drops, at moonshot's full width (E = 64, k = 6, D = 2048, d_ff
    1408), 512 tokens: float32 with cuBLAS's TF32 off, 1e-5 (sums in another
    order); bf16 products on both sides, 2^-7 (one bf16 rounding of each
    expert product's output and of the combine, a few ulps apart)."""
    cfg = port_registry.full_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    p = port_moe.init_moe(gen, cfg, dtype)
    t, k, e = 512, cfg.top_k, cfg.n_experts
    x = torch.randn(t, cfg.d_model, generator=gen).to(dtype)
    idx = torch.stack([torch.randperm(e, generator=gen)[:k] for _ in range(t)])
    idx[: t // 4, 0] = 0  # over expert 0's capacity: drops
    gates = torch.rand(t, k, generator=gen)
    gates = (gates / gates.sum(-1, keepdim=True)).to(dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = port_moe.expert_ffn(port_lm.tree_map(lambda a: a.to(cuda_device), p), cfg,
                                  x.to(cuda_device), idx.to(cuda_device), gates.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = port_moe.expert_ffn(p, cfg, x, idx, gates)
    assert not bool(port_moe.dispatch_slots(cfg, idx)[1].all())
    close(got.float(), want.float().numpy(), 1e-5 if dtype == torch.float32 else 2**-7)
