"""The port's flash attention against the reference's kernel and chunked attention.

The reference's Pallas kernel runs in interpret mode on the CPU, as
``tests/test_flash_attention.py`` runs it, at that file's shapes; the port's
wrapper, given CPU tensors, runs its plain version and leaves its launch
counter at 0.  atol 3e-4, the reference test's own.  The CUDA kernel runs
only on a card: the ``gpu`` test at the end holds it against the plain
version there and skips here.  On the CPU the two kernels' arithmetic is
emulated instead (``emulate_sm90``: the bf16 wgmma kernel; ``emulate_mma``:
the mma.sync kernel, 3xTF32 in float32) and held to the card's tolerance.
"""

import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.attention import _attend_chunked

ATOL = 3e-4


@pytest.fixture(scope="module")
def ref():
    """The reference's kernel wrapper and chunked attention.  Loaded here
    rather than at the top so the ``gpu`` test also runs on a card machine
    that has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention as ref_flash
    from repro.models.attention import _attend_chunked as ref_chunked

    return types.SimpleNamespace(jnp=jnp, flash=ref_flash, chunked=ref_chunked)


def qkv(seed, b, s, h, kh, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))


def launch_counts():
    return flash_ops.flash_attention_sm90.launches, flash_ops.flash_attention_mma.launches


def port(q, k, v, causal=True):
    launches = launch_counts()
    out = flash_attention(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal)
    assert launch_counts() == launches  # the plain version on the CPU
    return out.numpy()


# (b, s, h, kh, d, causal): tests/test_flash_attention.py's shapes
SHAPES = ([(2, s, 2, 2, 64, c) for s in (256, 512, 768) for c in (True, False)]
          + [(2, 512, h, kh, 32, True) for h, kh in ((4, 4), (4, 2), (8, 1))]
          + [(1, 1024, 2, 2, 32, True)])  # the causal tile-skip case
IDS = [f"b{b}-s{s}-h{h}-kh{kh}-d{d}-{'causal' if c else 'full'}" for b, s, h, kh, d, c in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_matches_reference_kernel(ref, shape):
    b, s, h, kh, d, causal = shape
    q, k, v = qkv(s + h, b, s, h, kh, d)
    want = ref.flash(*(ref.jnp.asarray(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(port(q, k, v, causal), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES + [(2, 1000, 4, 2, 64, True)],
                         ids=IDS + ["b2-s1000-h4-kh2-d64-causal-ragged"])
def test_matches_reference_chunked_attention(ref, shape):
    """The model's own attention, which the kernel replaces in the prefill;
    S = 1000 is ragged against every tile (the reference's kernel asserts
    S % 256 == 0 there, so it is held against the chunked attention only)."""
    b, s, h, kh, d, causal = shape
    q, k, v = qkv(s + 2 * h, b, s, h, kh, d)
    want = ref.chunked(*(ref.jnp.asarray(a) for a in (q, k, v)), causal=causal, chunk=128)
    np.testing.assert_allclose(port(q, k, v, causal), np.asarray(want), atol=ATOL)
    mine = _attend_chunked(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal, chunk=128)
    np.testing.assert_allclose(port(q, k, v, causal), mine.numpy(), atol=ATOL)


def test_causal_needs_equal_lengths():
    """Causal Sq != Sk has no one meaning in the reference: its Pallas kernel
    masks top-left (q_pos >= kv_pos) and its oracle bottom-right
    (tril(k=Sk-Sq)); at q (2, 256, 64), k/v (2, 512, 64), blk 128, on
    standard normals, they differ by up to 2.6-2.9 (2.90 from the draws of
    ``jax.random.split(PRNGKey(0), 3)``).  The port raises rather than pick
    one."""
    q = torch.zeros(1, 256, 2, 64)
    kv = torch.zeros(1, 512, 2, 64)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, kv, kv, causal=True)
    assert flash_attention(q, kv, kv, causal=False).shape == q.shape  # cross-attention


def test_rejects_mismatched_heads():
    with pytest.raises(ValueError, match="H % KH"):
        flash_attention(torch.zeros(1, 8, 6, 32), torch.zeros(1, 8, 4, 32),
                        torch.zeros(1, 8, 4, 32))


def test_bf16_output_keeps_dtype():
    q, k, v = (torch.as_tensor(a).bfloat16() for a in qkv(5, 1, 64, 4, 2, 32))
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(),
                               flash_attention_ref(q.float(), k.float(), v.float()).numpy(),
                               atol=1e-2)


# against the plain version in float32, over the whole output and row by
# row (each query row's error over its own largest |value|); see
# chip_smoke.py's TOL_FLASH for the reasoning
TOL_CARD = {torch.float32: 2e-5, torch.bfloat16: 2**-8 + 1e-4}
TOL_CARD_ROW = {torch.float32: 1e-4, torch.bfloat16: 2**-8 + 1e-4}


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 256, "sm90"),
    (torch.bfloat16, 32, "mma"),  # no wgmma instance: the mma.sync kernel
    (torch.float32, 64, "mma"), (torch.float32, 128, "mma"), (torch.float32, 256, "mma"),
    (torch.float32, 32, "mma"), (torch.float16, 128, "mma"),
    (torch.bfloat16, 8, "mma"), (torch.bfloat16, 16, "mma"),  # the SMOKE configs' heads
    (torch.float32, 8, "mma"), (torch.float32, 16, "mma"),
])
def test_kernel_routing_by_dtype_and_head_size(dtype, d, kernel):
    """bf16 at the wgmma kernel's head sizes goes to it; float32, and any D
    it has no instance for, to the mma.sync kernel (the wrapper raises for
    other dtypes before it routes)."""
    assert flash_ops.kernel_for(dtype, d) == kernel
    assert set(flash_ops.SM90_HEAD_DIMS) <= set(flash_ops.HEAD_DIMS)
    assert dtype == torch.float16 or d in flash_ops.HEAD_DIMS


def emulate_sm90(q, k, v, *, causal=True, block_k=128, split_p=True):
    """The bf16 tensor-core kernel's arithmetic on the CPU: bf16 q, k, v;
    scores q.k in float32, scaled by D^-1/2 log2(e) there and fed to exp2;
    an online softmax over ``block_k``-key tiles with the running max and
    sum and the P.V accumulator in float32, the sum taken from the float32
    p; P.V as P_hi V + P_lo V with P_hi = bf16(p), P_lo = bf16(p - P_hi) (or
    P_hi V alone, ``split_p=False``); o / l rounded to bf16."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qf, kf, vf = (t.float().repeat_interleave(r, dim=2).transpose(1, 2)
                  for t, r in ((q, 1), (k, g), (v, g)))  # (B, H, S, D)
    c = d**-0.5 * math.log2(math.e)
    m = torch.full((b, h, s, 1), -1e30)
    l, o = torch.zeros(b, h, s, 1), torch.zeros(b, h, s, d)
    for k0 in range(0, s, block_k):
        keys = slice(k0, min(k0 + block_k, s))
        t = qf @ kf[:, :, keys].transpose(-1, -2) * c
        if causal:
            t = t.masked_fill(torch.arange(k0, keys.stop)[None, :] > torch.arange(s)[:, None],
                              -1e30)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        corr, m = torch.exp2(m - m_new), m_new
        p = torch.exp2(t - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vf[:, :, keys]
        if split_p:
            pv = pv + (p - p_hi).bfloat16().float() @ vf[:, :, keys]
        o = o * corr + pv
    return (o / l).transpose(1, 2).bfloat16()


def row_rel_err(got, want):
    """The largest per-query-row error over that row's largest |value|."""
    diff = (got.float() - want).abs().flatten(2).amax(-1)
    return float((diff / want.abs().flatten(2).amax(-1)).max())


@pytest.mark.parametrize("split_p,within", [(True, True), (False, False)],
                         ids=["p-hi-plus-lo", "single-bf16-p"])
def test_sm90_numerics_emulated_against_float32(split_p, within):
    """At 2 heads, S = 512, D = 128, causal, from bf16 inputs: with P split
    into bf16 hi + lo the emulated kernel stays within the card's bf16 limit
    (2^-8 + 1e-4, row by row) of the float32 plain version (3.79e-3 here, the
    output's own rounding); with a single bf16 P it does not (4.70e-3)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 2, 128)).astype(np.float32))
               .bfloat16() for _ in range(3))
    want = flash_attention_ref(q.float(), k.float(), v.float())
    err = row_rel_err(emulate_sm90(q, k, v, split_p=split_p), want)
    assert (err <= TOL_CARD_ROW[torch.bfloat16]) == within, err
    assert row_rel_err(want.bfloat16(), want) <= TOL_CARD_ROW[torch.bfloat16]


def tf32(x):
    """``cvt.rna.tf32.f32``: to nearest, ties away from zero, 10 mantissa bits
    (the 13 low bits of the float32 pattern cleared after adding half of
    them; the sign is a separate bit, so the magnitude rounds up on a tie)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x):
    """x cut to TF32 (the 13 low bits cleared): what the tensor core reads of
    a float32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def emulate_mma(q, k, v, *, causal=True, block_k=None, products=3, split_p=True):
    """The mma.sync kernel's arithmetic on the CPU.  float32: q scaled by
    D^-1/2 log2(e), then every product of Q.K^T and P.V taken as three TF32
    products of split operands, a_lo b_hi + a_hi b_lo + a_hi b_hi with a_hi =
    tf32(a) and a_lo = a - a_hi cut to TF32 (or the single a_hi b_hi,
    ``products=1``), summed in float32; an online softmax over the kernel's
    key tile (32 keys at D >= 128, else 64) with exp2, masked scores -1e30,
    each tile's P.V added to O at its end; o / max(l, 1e-30).  bf16 (D = 8,
    16, 32): :func:`emulate_sm90`'s arithmetic at the kernel's 64-key tile, P
    split into bf16 hi + lo (or not, ``split_p=False``)."""
    b, s, h, d = q.shape
    if q.dtype == torch.bfloat16:
        return emulate_sm90(q, k, v, causal=causal, block_k=block_k or 64, split_p=split_p)
    block_k = block_k or (32 if d >= 128 else 64)
    g = h // k.shape[2]
    qf, kf, vf = (t.float().repeat_interleave(r, dim=2).transpose(1, 2)
                  for t, r in ((q, 1), (k, g), (v, g)))  # (B, H, S, D)
    qf = qf * (d**-0.5 * math.log2(math.e))

    def mm(x, y):
        xh, yh = tf32(x), tf32(y)
        if products == 1:
            return xh @ yh
        return tf32_cut(x - xh) @ yh + xh @ tf32_cut(y - yh) + xh @ yh

    m = torch.full((b, h, s, 1), -1e30)
    l, o = torch.zeros(b, h, s, 1), torch.zeros(b, h, s, d)
    for k0 in range(0, k.shape[1], block_k):
        keys = slice(k0, min(k0 + block_k, k.shape[1]))
        t = mm(qf, kf[:, :, keys].transpose(-1, -2))
        if causal:
            t = t.masked_fill(torch.arange(k0, keys.stop)[None, :] > torch.arange(s)[:, None],
                              -1e30)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        corr, m = torch.exp2(m - m_new), m_new
        p = torch.exp2(t - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, vf[:, :, keys])
    return (o / l.clamp_min(1e-30)).transpose(1, 2)


def card_errors(got, want):
    """(over the output, row by row): the ``gpu`` test's two norm-relative errors."""
    diff = (got.float() - want).abs().flatten(2).amax(-1)  # (B, S)
    scale = want.abs().flatten(2).amax(-1)
    return float(diff.max() / scale.max()), float((diff / scale).max())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # the TF32 ulp above 1
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-20,
                      one + 2.0**-11, 3.0, 0.0])
    assert torch.equal(tf32(x), torch.tensor([one, -one, 1.0, one + 2.0**-10, 3.0, 0.0]))
    assert torch.equal(tf32_cut(x), torch.tensor([1.0, -1.0, 1.0, one, 3.0, 0.0]))
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    assert float(((tf32(y) - y).abs() / y.abs()).max()) <= 2.0**-11
    # hi + lo keeps 21 of float32's 24 bits
    split = tf32(y) + tf32_cut(y - tf32(y))
    assert float(((split - y).abs() / y.abs()).max()) <= 2.0**-21


# (dtype, b, s, h, kh, d, causal): every instance of the kernel, GQA, causal
# and full, S ragged against the key tiles (300, 200) and not (256)
MMA_CASES = ([(torch.float32, 1, 300, 4, 2, d, True) for d in (8, 16, 32, 64, 128, 256)]
             + [(torch.float32, 1, 200, 4, 1, 64, False), (torch.float32, 1, 256, 2, 2, 128, False)]
             + [(torch.bfloat16, 2, 300, 6, 2, d, True) for d in (8, 16, 32)]
             + [(torch.bfloat16, 1, 200, 4, 4, 16, False)])


@pytest.mark.parametrize("case", MMA_CASES, ids=[
    f"{str(dt).removeprefix('torch.')}-b{b}-s{s}-h{h}-kh{kh}-d{d}-{'causal' if c else 'full'}"
    for dt, b, s, h, kh, d, c in MMA_CASES])
def test_mma_numerics_emulated_against_float32(case):
    """The emulated mma.sync kernel within the card's limits of the float32
    plain version, over the output and row by row: what
    ``test_kernel_matches_plain_version_on_card`` asks of the kernel."""
    dt, b, s, h, kh, d, causal = case
    q, k, v = (torch.from_numpy(a).to(dt) for a in qkv(s + d, b, s, h, kh, d))
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    got = emulate_mma(q, k, v, causal=causal)
    assert got.dtype == dt
    err, row = card_errors(got, want)
    assert err <= TOL_CARD[dt] and row <= TOL_CARD_ROW[dt], (err, row)


def test_mma_single_tf32_product_fails_float32_limit():
    """Why float32 takes three TF32 products: at D = 128 one (~11 bits an
    operand) is ~20x over TOL_CARD (4.3e-4), where three stay ~30x inside it
    (6.2e-7)."""
    q, k, v = (torch.from_numpy(a) for a in qkv(7, 1, 256, 4, 2, 128))
    want = flash_attention_ref(q, k, v)
    one = card_errors(emulate_mma(q, k, v, products=1), want)[0]
    three = card_errors(emulate_mma(q, k, v), want)[0]
    assert one > TOL_CARD[torch.float32] > 5 * three, (one, three)


def test_mma_single_bf16_p_fails_bf16_row_limit():
    """Why bf16 splits P: at the train CLI's SMOKE shape (B = 16, S = 256, H =
    6 over KH = 2, D = 8) a single bf16 P misses the bf16 row limit (5.96e-3
    against 4.0e-3), P_hi + P_lo meets it (3.84e-3, the output's own
    rounding)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in qkv(8, 16, 256, 6, 2, 8))
    want = flash_attention_ref(q.float(), k.float(), v.float())
    single = card_errors(emulate_mma(q, k, v, split_p=False), want)[1]
    split = card_errors(emulate_mma(q, k, v), want)[1]
    assert single > TOL_CARD_ROW[torch.bfloat16] >= split, (single, split)


def test_mma_emulation_matches_reference_kernel(ref):
    """The emulated float32 kernel against the reference's Pallas kernel in
    interpret mode, at the file's atol."""
    q, k, v = qkv(9, 2, 256, 4, 2, 32)
    want = ref.flash(*(ref.jnp.asarray(a) for a in (q, k, v)), causal=True)
    got = emulate_mma(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash attention kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,causal", [(2, 512, 4, 2, 64, True), (2, 1000, 8, 1, 32, True),
                                               (1, 300, 4, 4, 128, False),
                                               (1, 256, 2, 1, 256, True),
                                               (2, 1000, 8, 1, 128, True),
                                               (2, 512, 4, 2, 64, False),
                                               (1, 1000, 4, 2, 256, False),
                                               (2, 300, 6, 2, 8, True),
                                               (2, 256, 4, 4, 16, True),
                                               (1, 300, 4, 2, 16, False)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, b, s, h, kh, d, causal):
    """Norm-relative, against the plain version in float32: 2e-5 over the
    output and 1e-4 row by row in float32 (sums in another order); in bf16
    2^-8 + 1e-4 both ways (the output's rounding to nearest as well).  bf16
    at D = 64, 128 and 256 runs the wgmma kernel, the rest the mma.sync
    kernel: the counter of the routed kernel alone moves."""
    g = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device=cuda_device).to(dtype)
               for n in (h, kh, kh))
    kernel = flash_ops.kernel_for(dtype, d)
    launches = launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    moved = (launches[0] + (kernel == "sm90"), launches[1] + (kernel == "mma"))
    assert launch_counts() == moved and got.dtype == dtype
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    diff = (got.float() - want).abs().flatten(2).amax(-1)  # (B, S)
    scale = want.abs().flatten(2).amax(-1)
    assert float(diff.max() / scale.max()) <= TOL_CARD[dtype]
    assert float((diff / scale).max()) <= TOL_CARD_ROW[dtype]
    with pytest.raises(ValueError, match="contiguous"):  # a strided view: no copy, a raise
        flash_attention(q.transpose(1, 2), k, v, causal=False)
    with pytest.raises(ValueError, match="float32 or bf16"):
        flash_attention(q.half(), k.half(), v.half(), causal=causal)
