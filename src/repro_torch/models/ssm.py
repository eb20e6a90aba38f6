"""Mamba-2 (SSD) block: the chunked form for prefill and training, the
recurrent step for decode.

Port of ``repro/models/ssm.py`` (Dao & Gu, arXiv:2405.21060).  The sequence
is split into chunks of ``CHUNK`` positions; within a chunk the state-space
map is a masked (semiseparable) attention-like product, and the chunk
boundary states are carried by a loop over the chunks (the reference's
``lax.scan``).  The decays are ``exp`` of clipped differences of cumulative
log-decays, computed in float32 as the reference computes them.  Decode
carries the (H, N, P) state exactly, ``h_t = a_t h_{t-1} + dt_t B_t x_t``,
``y_t = C_t h_t + D x_t``, and the rolling window of the causal conv.

The reference has no kernel here, so this is plain torch mirroring its
steps and casts.  Its three-operand einsums are contracted pairwise in an
order that never builds a (chunk, H, N, P) intermediate.

Under active sharding rules (:mod:`repro_torch.dist.sharding`) the forward
runs this rank's SSM heads where ``ssm_inner`` splits over the model axis
(:func:`mamba2_forward`), and the decode runs every head on each model
rank against the whole cache (:func:`mamba2_decode`); ``in_proj`` and
``out_proj`` are FSDP blocks over ``data`` in both.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..dist import sharding
from .config import ModelConfig
from .layers import dense_init, init_norm, rmsnorm, rmsnorm_split

CHUNK = 128


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    din, ns, g = cfg.d_ssm_inner, cfg.ssm_state, cfg.ssm_groups
    nh = cfg.n_ssm_heads
    conv_dim = din + 2 * g * ns
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * din + 2 * g * ns + nh, dtype),
        "conv_w": (torch.randn((cfg.ssm_conv, conv_dim), device=dev,
                               generator=None if dev.type == "meta" else gen) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm": init_norm(din, dtype, dev),
        "out_proj": dense_init(gen, din, d, dtype),
    }


class Mamba2Cache(NamedTuple):
    conv: torch.Tensor  # (B, conv_width - 1, conv_dim) — rolling conv window
    state: torch.Tensor  # (B, H, N, P) float32 — SSM state
    length: torch.Tensor  # (B,)


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> Mamba2Cache:
    din, ns, g = cfg.d_ssm_inner, cfg.ssm_state, cfg.ssm_groups
    conv_dim = din + 2 * g * ns
    return Mamba2Cache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.n_ssm_heads, ns, cfg.ssm_head_dim), dtype=torch.float32,
                          device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """-> (gate z, conv input xBC, dt logits) along the last axis."""
    din, ns, g = cfg.d_ssm_inner, cfg.ssm_state, cfg.ssm_groups
    return torch.split(zxbcdt, [din, din + 2 * g * ns, cfg.n_ssm_heads], dim=-1)


def _causal_conv(cfg: ModelConfig, xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence: xbc (B, S, C), w (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):  # k is 4: unrolled, as the reference
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def _ssd_chunked(x, dt, a_log, B, C, d_skip, chunk=CHUNK):
    """Chunked SSD.  x (Bt, T, H, P), dt (Bt, T, H), B and C (Bt, T, G, N),
    T a multiple of ``chunk`` -> y (Bt, T, H, P), final state (Bt, H, N, P)."""
    bt, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc = t // chunk
    A = -torch.exp(a_log)  # (H,) negative

    xc = x.reshape(bt, nc, chunk, h, p)
    dtc = dt.reshape(bt, nc, chunk, h)
    Bc = B.reshape(bt, nc, chunk, g, n).repeat_interleave(rep, dim=3)  # (bt, nc, Q, H, N)
    Cc = C.reshape(bt, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    da = dtc * A  # (bt, nc, Q, H) log-decay per step
    cum = torch.cumsum(da, dim=2)  # S_i (inclusive)
    seg_total = cum[:, :, -1, :]  # (bt, nc, H)

    # intra-chunk: G[i, j] = C_i . B_j * exp(S_i - S_j) * dt_j for j <= i
    li = cum[:, :, :, None, :]  # (bt, nc, Q, 1, H)
    lj = cum[:, :, None, :, :]  # (bt, nc, 1, Q, H)
    decay = torch.exp(torch.clamp(li - lj, -60.0, 0.0))  # (bt, nc, Q, Q, H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
    scores = scores * decay * dtc[:, :, None, :, :]
    scores = torch.where(mask[None, None, :, :, None], scores, 0.0)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)

    # chunk summary states: sum_j exp(S_Q - S_j) dt_j B_j x_j^T
    w = torch.exp(torch.clamp(seg_total[:, :, None, :] - cum, -60.0, 0.0)) * dtc
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp", w[..., None] * Bc, xc)

    # inter-chunk recurrence: the state entering each chunk
    h_prev = torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device)
    carry = torch.exp(torch.clamp(seg_total, -60.0, 0.0))  # (bt, nc, H)
    h_in = []
    for c in range(nc):
        h_in.append(h_prev)
        h_prev = h_prev * carry[:, c, :, None, None] + chunk_state[:, c].float()
    h_in = torch.stack(h_in, dim=1)  # (bt, nc, H, N, P)

    # inter-chunk contribution: C_i . h_in * exp(S_i)
    decay_in = torch.exp(torch.clamp(cum, -60.0, 0.0)).to(Cc.dtype)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Cc * decay_in[..., None], h_in.to(Cc.dtype))

    y = (y_intra + y_inter).reshape(bt, t, h, p) + x * d_skip[None, None, :, None]
    return y, h_prev


def _rank_params(params: dict, cfg: ModelConfig) -> dict:
    """This rank's share of a Mamba-2 layer's parameters: the whole layer
    without rules or where ``ssm_inner`` is not split (``in_proj`` /
    ``out_proj`` gathered over ``data`` where ``fsdp`` splits them); under
    rules that split it, the columns of ``in_proj`` its SSM heads read (its
    heads' gate, x and dt columns and its heads' groups' B and C), their
    conv channels, its heads' ``a_log`` / ``dt_bias`` / ``d_skip``, its
    columns of ``norm`` and its rows of ``out_proj``.  Every one of those
    leaves is replicated on ``model`` and the rank uses part of it, so each
    passes ``grad_reduce_boundary`` before it is cut (its gradient summed
    over the model group in the backward: an all-reduce of the leaf as the
    rank holds it, ``in_proj`` D / data x (2 din + 2 G N + H) and
    ``out_proj`` din x D / data elements the largest); ``in_proj`` and
    ``out_proj`` are cut before their FSDP gather, so the gather over the
    data group moves the rank's columns (rows) alone.  Two
    model ranks that share a group (``n_ssm_heads / ssm_groups`` above the
    heads a rank holds: zamba2-1.2b at TP 16) each take that group's B and C.
    ``head_group`` maps each local head to its local group (``None`` off
    the split)."""
    din, ns, g = cfg.d_ssm_inner, cfg.ssm_state, cfg.ssm_groups
    nh, p = cfg.n_ssm_heads, cfg.ssm_head_dim
    keys = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip")
    if sharding.split("ssm_inner")[0] == 1:
        return dict({k: params[k] for k in keys},
                    in_proj=sharding.fsdp_gather(params["in_proj"], 0),
                    out_proj=sharding.fsdp_gather(params["out_proj"], 1),
                    norm=params["norm"]["scale"], heads=nh, groups=g, head_group=None)
    hl, h0 = sharding.local_block(nh, "ssm_inner", "mamba SSM heads")
    rep = nh // g
    g0 = h0 // rep
    gl = (h0 + hl - 1) // rep - g0 + 1
    dev = params["in_proj"].device
    ar = lambda a, n: torch.arange(a, a + n, device=dev)
    xs = ar(h0 * p, hl * p)
    conv = torch.cat([xs, ar(din + g0 * ns, gl * ns), ar(din + (g + g0) * ns, gl * ns)])
    cols = torch.cat([xs, din + conv, ar(2 * din + 2 * g * ns + h0, hl)])
    r = {k: sharding.grad_reduce_boundary(params[k]) for k in keys + ("in_proj", "out_proj")}
    return dict(
        in_proj=sharding.fsdp_gather(r["in_proj"].index_select(1, cols), 0),
        out_proj=sharding.fsdp_gather(r["out_proj"].narrow(0, h0 * p, hl * p), 1),
        conv_w=r["conv_w"].index_select(1, conv), conv_b=r["conv_b"].index_select(0, conv),
        a_log=r["a_log"].narrow(0, h0, hl), dt_bias=r["dt_bias"].narrow(0, h0, hl),
        d_skip=r["d_skip"].narrow(0, h0, hl),
        norm=sharding.grad_reduce_boundary(params["norm"]["scale"]).narrow(0, h0 * p, hl * p),
        heads=hl, groups=gl, head_group=torch.div(ar(h0, hl), rep, rounding_mode="floor") - g0)


def mamba2_forward(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, D); S is padded to a multiple of CHUNK inside.

    Under rules that split ``ssm_inner`` over the model axis (the
    reference's ``constrain(xs, "batch", None, "ssm_inner")``) the rank runs
    its SSM heads (:func:`_rank_params`): ``x`` enters through
    ``grad_reduce_boundary``, the gated RMSNorm over ``d_ssm_inner`` sums
    its squares over the model ranks (``model_sum``: an all-reduce of B x S
    floats each way), and the rank's rows of ``out_proj`` give a partial
    output summed by ``constrain`` (an all-reduce of B x S x D)."""
    b, s, _ = x.shape
    ns, p = cfg.ssm_state, cfg.ssm_head_dim
    r = _rank_params(params, cfg)
    hl, gl = r["heads"], r["groups"]
    tp = r["head_group"] is not None
    if tp:
        x = sharding.grad_reduce_boundary(x)

    z, xbc, dt_logit = torch.split(x @ r["in_proj"], [hl * p, hl * p + 2 * gl * ns, hl], dim=-1)
    xbc = _causal_conv(cfg, xbc, r["conv_w"], r["conv_b"])
    xs, B, C = torch.split(xbc, [hl * p, gl * ns, gl * ns], dim=-1)

    dt = F.softplus(dt_logit.float() + r["dt_bias"].float())  # (B, S, H)
    xh = xs.reshape(b, s, hl, p)
    Bh = B.reshape(b, s, gl, ns)
    Ch = C.reshape(b, s, gl, ns)
    if tp:  # each local head's group, G = H
        Bh, Ch = Bh.index_select(2, r["head_group"]), Ch.index_select(2, r["head_group"])

    pad = (-s) % CHUNK
    if pad:
        xh, Bh, Ch = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (xh, Bh, Ch))
        dt = F.pad(dt, (0, 0, 0, pad))

    y, _ = _ssd_chunked(xh.float(), dt, r["a_log"].float(), Bh.float(), Ch.float(),
                        r["d_skip"].float())
    y = y[:, :s].reshape(b, s, hl * p).to(x.dtype)
    y = y * F.silu(z)  # gated
    if tp:
        y = rmsnorm_split(r["norm"], y, cfg.d_ssm_inner, cfg.norm_eps)
        return sharding.constrain(y @ r["out_proj"])
    y = rmsnorm({"scale": r["norm"]}, y, cfg.norm_eps)
    return y @ r["out_proj"]


def mamba2_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: Mamba2Cache) -> Tuple[torch.Tensor, Mamba2Cache]:
    """One position (B, 1, D) through the recurrence -> (y, the new cache);
    the given cache is left as it was.  Under active rules the cache is
    whole on every model rank (``launch.partition.cache_shardings``), so
    every rank runs every head on the whole layer: ``in_proj`` and
    ``out_proj`` gathered over ``data`` where ``fsdp`` splits them, no
    collective over ``model``, each rank's new cache the one-rank cache."""
    b = x.shape[0]
    din, ns, g = cfg.d_ssm_inner, cfg.ssm_state, cfg.ssm_groups
    nh, p = cfg.n_ssm_heads, cfg.ssm_head_dim

    z, xbc, dt_logit = _split_proj(cfg, x @ sharding.fsdp_gather(params["in_proj"], 0))
    window = torch.cat([cache.conv, xbc], dim=1)  # (B, K, C): the rolling causal conv
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"])

    xs, B, C = torch.split(conv_out, [din, g * ns, g * ns], dim=-1)
    dt = F.softplus(dt_logit[:, 0].float() + params["dt_bias"].float())  # (B, H)
    a = torch.exp(dt * -torch.exp(params["a_log"].float()))  # (B, H)

    xh = xs.reshape(b, nh, p).float()
    rep = nh // g
    Bh = B.reshape(b, g, ns).repeat_interleave(rep, dim=1).float()  # (B, H, N)
    Ch = C.reshape(b, g, ns).repeat_interleave(rep, dim=1).float()

    state = cache.state * a[:, :, None, None] + (dt[:, :, None] * Bh)[..., None] * xh[:, :, None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, state) + xh * params["d_skip"][None, :, None]
    y = y.reshape(b, 1, din).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    out = y @ sharding.fsdp_gather(params["out_proj"], 1)
    return out, Mamba2Cache(conv=window[:, 1:], state=state, length=cache.length + 1)
