"""The invariants of ``tests/test_properties.py`` and the attention cases of
``tests/test_blocks.py``, over the port.

The reference draws its property cases with ``hypothesis``; here each
property runs on a fixed set of seeded cases (``parametrize``), the inputs
drawn with numpy or a CPU ``torch.Generator`` from the seed, with the
reference tests' own limits: the recovery invariants, then the LM
substrate's (RoPE, RMSNorm, the MoE combine weights, AdamW on a quadratic),
then ``tests/test_blocks.py``'s three GQA cases (chunked attention against
a naive softmax, the sliding window, decode against the forward).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.core import RecoveryProblem, partial_gaussian_circulant, solve
from repro_torch.core.circulant import gaussian_circulant, romberg_circulant
from repro_torch.core.ista import lasso_objective
from repro_torch.core.soft_threshold import soft_threshold
from repro_torch.data.synthetic import paper_regime, sparse_signal
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_rope, init_norm, rmsnorm
from repro_torch.models.moe import _routing
from repro_torch.optim import adamw


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _normal(seed, *shape, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


@pytest.mark.parametrize("seed,gamma,n", [(0, 0.0, 1), (1, 0.7, 57), (2, 3.0, 200),
                                          (3, 1.5, 128)])
def test_soft_threshold_is_nonexpansive_shrinkage(seed, gamma, n):
    x, y = _normal(seed, n, scale=3), _normal(seed + 1000, n, scale=3)
    sx, sy = soft_threshold(x, gamma), soft_threshold(y, gamma)
    # prox operators are firmly non-expansive
    assert float((sx - sy).norm()) <= float((x - y).norm()) + 1e-5
    # shrinkage: |sx| <= |x| elementwise, sign preserved or zeroed
    assert bool((sx.abs() <= x.abs() + 1e-6).all())
    assert bool(((sx == 0) | (torch.sign(sx) == torch.sign(x))).all())
    # exact kill zone
    assert bool((sx[x.abs() <= gamma] == 0).all())


@pytest.mark.parametrize("n,seed", [(4, 0), (37, 11), (128, 2024)])
def test_spectrum_homomorphism(n, seed):
    A = gaussian_circulant(_gen(seed), n, device="cpu")
    B = gaussian_circulant(_gen(seed + 1), n, device="cpu")
    scale = float(A.spec.abs().max() * B.spec.abs().max())
    # product of circulants -> product of spectra
    np.testing.assert_allclose(A.compose(B).spec.numpy(), (A.spec * B.spec).numpy(),
                               rtol=1e-3, atol=1e-2 * scale)
    # commutativity (circulants always commute)
    x = _normal(seed, n)
    np.testing.assert_allclose(
        A.matvec(B.matvec(x)).numpy(), B.matvec(A.matvec(x)).numpy(),
        atol=2e-2 * max(1.0, float(x.abs().max()))
        * float(A.operator_norm() * B.operator_norm()) / n,
    )


@pytest.mark.parametrize("n,seed", [(8, 0), (77, 5), (128, 31337)])
def test_parseval_for_romberg(n, seed):
    """Unit-spectrum sensing is an isometry: ||Cx|| == ||x||."""
    C = romberg_circulant(_gen(seed), n, device="cpu")
    x = _normal(seed, n)
    np.testing.assert_allclose(float(C.matvec(x).norm()), float(x.norm()), rtol=1e-4)


@pytest.mark.parametrize("n,seed", [(4, 0), (50, 9), (100, 4242)])
def test_adjoint_identity(n, seed):
    """<Cx, y> == <x, C^T y> — the identity ISTA's gradient step relies on."""
    C = gaussian_circulant(_gen(seed), n, device="cpu")
    x, y = _normal(seed, n), _normal(seed + 1, n)
    lhs = float(torch.dot(C.matvec(x), y))
    rhs = float(torch.dot(x, C.rmatvec(y)))
    assert abs(lhs - rhs) <= 1e-3 * (abs(lhs) + abs(rhs) + 1.0)


@pytest.mark.parametrize("seed", [0, 17, 4095])
def test_solver_beats_zero_solution(seed):
    n = 128
    m, k = paper_regime(n)
    g = _gen(seed)
    x = sparse_signal(g, n, k, device="cpu")
    op = partial_gaussian_circulant(g, n, m, normalize=True, device="cpu")
    prob = RecoveryProblem(op=op, y=op.matvec(x), x_true=x)
    xh, _ = solve(prob, "cpadmm", iters=150, record_every=150, alpha=1e-4, rho=0.01,
                  sigma=0.01)
    obj_zero = float(lasso_objective(op, prob.y, torch.zeros_like(xh), 1e-4))
    obj_hat = float(lasso_objective(op, prob.y, xh, 1e-4))
    assert obj_hat < obj_zero


# ---------------------------------------------------------------------------
# substrate invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,dh,seed", [(1, 8, 0), (3, 16, 7), (17, 32, 123), (32, 8, 65535)])
def test_rope_preserves_norms_and_relative_positions(s, dh, seed):
    x = _normal(seed, 1, s, 2, dh)
    y = apply_rope(x, torch.arange(s).expand(1, s), 1e4)
    # a rotation: each position's norm is kept
    np.testing.assert_allclose(y.norm(dim=-1).numpy(), x.norm(dim=-1).numpy(), rtol=2e-3)
    # relative: <rope(q, i), rope(k, j)> depends on i - j alone
    if s >= 3:
        q, k = _normal(seed + 1, 1, 1, 1, dh), _normal(seed + 2, 1, 1, 1, dh)

        def dot_at(i, j):
            qi = apply_rope(q, torch.full((1, 1), i), 1e4)
            kj = apply_rope(k, torch.full((1, 1), j), 1e4)
            return float((qi * kj).sum())

        assert abs(dot_at(2, 1) - dot_at(1, 0)) < 1e-3


@pytest.mark.parametrize("d,seed", [(8, 0), (32, 11), (128, 4242)])
def test_rmsnorm_output_scale(d, seed):
    y = rmsnorm(init_norm(d, torch.float32), _normal(seed, 4, d, scale=10))
    np.testing.assert_allclose(y.square().mean(dim=-1).sqrt().numpy(), 1.0, rtol=2e-2)


@pytest.mark.parametrize("seed", [0, 1, 2, 4095])
def test_moe_combine_weights_normalized(seed):
    cfg = smoke_config("deepseek-v3-671b")
    x = _normal(seed, 24, cfg.d_model)
    params = {"router": _normal(seed + 1, cfg.d_model, cfg.n_experts, scale=0.02),
              "router_bias": torch.zeros(cfg.n_experts)}
    idx, gates, aux = _routing(params, cfg, x)
    np.testing.assert_allclose(gates.sum(dim=-1).numpy(), 1.0, atol=1e-3)
    assert tuple(idx.shape) == (24, cfg.top_k)
    assert float(aux) >= 0.99  # the balance loss is >= 1 at (near-)uniform routing


def test_adamw_decreases_quadratic():
    cfg = adamw.AdamWConfig(lr_peak=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params, cfg)
    loss = lambda p: (p["w"] ** 2).sum()
    l0 = float(loss(params))
    for _ in range(50):
        w = params["w"].detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(loss({"w": w}), (w,))
        params, state, _ = adamw.update(params, {"w": grad}, state, cfg)
    assert float(loss(params)) < l0 * 0.1


# ---------------------------------------------------------------------------
# attention: chunked online softmax against a naive softmax, decode against forward
# ---------------------------------------------------------------------------


def _naive_attention(q, k, v, causal, window=0):
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    qf = (q * dh**-0.5).reshape(b, sq, kh, h // kh, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k)
    if causal:
        mask = torch.tril(torch.ones((sq, k.shape[1]), dtype=torch.bool))
        if window:
            mask = mask & (torch.arange(k.shape[1])[None, :] > torch.arange(sq)[:, None] - window)
        s = s.masked_fill(~mask, -1e30)
    o = torch.einsum("bkgqs,bskd->bkgqd", torch.softmax(s, dim=-1), v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, -1)


@pytest.mark.parametrize("gqa", [(4, 4), (4, 2), (8, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("sq,chunk", [(16, 8), (64, 16), (33, 16)])
def test_chunked_attention_matches_naive(sq, chunk, gqa):
    h, kh = gqa
    q, k, v = _normal(0, 2, sq, h, 16), _normal(1, 2, sq, kh, 16), _normal(2, 2, sq, kh, 16)
    got = attn_mod._attend_chunked(q, k, v, causal=True, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _naive_attention(q, k, v, True).numpy(), atol=2e-4)


def test_sliding_window_attention():
    sq, h, dh, win = 32, 2, 8, 8
    q, k, v = (_normal(seed, 1, sq, h, dh) for seed in (3, 4, 5))
    got = attn_mod._attend_chunked(q, k, v, causal=True, chunk=16, sliding_window=win)
    np.testing.assert_allclose(got.numpy(), _naive_attention(q, k, v, True, win).numpy(),
                               atol=2e-4)


def test_gqa_decode_matches_forward():
    """Feeding positions one at a time through the KV cache reproduces the
    parallel attention (on the CPU the flash kernel's plain version)
    position by position."""
    cfg = dataclasses.replace(smoke_config("codeqwen1.5-7b"), dtype="float32")
    params = attn_mod.init_gqa(torch.Generator().manual_seed(0), cfg, torch.float32)
    b, s = 2, 12
    x = _normal(1, b, s, cfg.d_model, scale=0.3)
    full = attn_mod.gqa_forward(params, cfg, x, torch.arange(s).expand(b, s))
    cache = attn_mod.init_kv_cache(cfg, b, 16, torch.float32, "cpu")
    outs = []
    for t in range(s):
        y, cache = attn_mod.gqa_decode(params, cfg, x[:, t:t + 1], cache)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), atol=3e-4)
