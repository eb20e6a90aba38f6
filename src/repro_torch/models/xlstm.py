"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, sequential) — Beck et al., arXiv:2405.04517.

Port of ``repro/models/xlstm.py``.  mLSTM runs its chunked form: quadratic
within a chunk of ``CHUNK`` positions, a gate-decay recurrence across the
chunks (a loop, the reference's ``lax.scan``), stabilised in log space by a
running maximum ``m``.  sLSTM has a true hidden-to-gate recurrence, so its
forward is a loop over time, as the reference scans it; the input half of
its gates (``x_t W_x``) does not depend on the recurrence and is computed
for every position in one product before the loop.  Decode carries mLSTM's
(C, n, m) a head and sLSTM's (c, n, h, m).

The reference has no kernel here, so this is plain torch mirroring its
steps and casts.

Under active sharding rules (:mod:`repro_torch.dist.sharding`) that split
``ssm_inner`` over the model axis, mLSTM runs the rank's column block of
its heads (:func:`mlstm_forward`), sLSTM its recurrence whole on every
model rank with ``w_down`` row-parallel (:func:`slstm_forward`); the
decode caches are whole on every model rank, each the one-rank cache.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..dist import sharding
from .config import ModelConfig
from .layers import dense_init, init_norm, rmsnorm, rmsnorm_split

CHUNK = 256
_NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    din = 2 * d  # xLSTM pf=2 up-projection
    h = cfg.n_heads
    return {
        "w_up": dense_init(gen, d, 2 * din, dtype),  # x-branch + gate-branch
        "w_q": dense_init(gen, din, din, dtype),
        "w_k": dense_init(gen, din, din, dtype),
        "w_v": dense_init(gen, din, din, dtype),
        "w_i": dense_init(gen, din, h, dtype),  # input gate (per head)
        "w_f": dense_init(gen, din, h, dtype),  # forget gate
        "w_o": dense_init(gen, din, din, dtype),  # output gate proj
        "norm": init_norm(din, dtype, gen.device),
        "w_down": dense_init(gen, din, d, dtype),
    }


class MlstmCache(NamedTuple):
    C: torch.Tensor  # (B, H, Dk, Dv)
    n: torch.Tensor  # (B, H, Dk)
    m: torch.Tensor  # (B, H) log-space gate max
    length: torch.Tensor


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> MlstmCache:
    h = cfg.n_heads
    dk = 2 * cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return MlstmCache(
        C=torch.zeros((batch, h, dk, dk), **f32),
        n=torch.zeros((batch, h, dk), **f32),
        m=torch.full((batch, h), _NEG, **f32),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _clamp_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def _mlstm_parallel(q, k, v, i_gate, f_gate):
    """Stabilised chunkwise-quadratic mLSTM.  q, k (B, T, H, Dk), v (B, T,
    H, Dv) (Dv = Dk but on a model rank holding part of a head's columns);
    the gates (B, T, H) raw logits; T a multiple of CHUNK -> (B, T, H, Dv)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    logf = F.logsigmoid(f_gate.float())  # (B, T, H)
    logi = i_gate.float()
    nc = t // CHUNK

    qc = q.reshape(b, nc, CHUNK, h, dk).float() * dk**-0.5
    kc = k.reshape(b, nc, CHUNK, h, dk).float()
    vc = v.reshape(b, nc, CHUNK, h, dv).float()
    lf = logf.reshape(b, nc, CHUNK, h)
    li = logi.reshape(b, nc, CHUNK, h)

    Fc = torch.cumsum(lf, dim=2)  # (b, nc, Q, h) inclusive log-forget prefix
    Ftot = Fc[:, :, -1, :]

    # log weight of source j for target i within a chunk: F_i - F_j + logi_j
    lw = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + li[:, :, None, :, :]
    mask = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=q.device))
    lw = torch.where(mask[None, None, :, :, None], lw, _NEG)  # finite: -inf NaNs the backward

    C_prev = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    n_prev = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    m_prev = torch.full((b, h), _NEG, dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nc):
        qb, kb, vb, lwb, Fb, lib, Ftotb = (qc[:, c], kc[:, c], vc[:, c], lw[:, c], Fc[:, c],
                                          li[:, c], Ftot[:, c])
        # the incoming state's log weight for target i, F_i + m_prev, and the
        # stabiliser max(max_j lw, F_i + m_prev)
        state_lw = Fb + m_prev[:, None, :]  # (b, Q, h)
        m_i = torch.maximum(lwb.amax(dim=2), state_lw)  # masked entries are -1e30

        w_intra = torch.where(mask[None, :, :, None], _clamp_exp(lwb - m_i[:, :, None, :]), 0.0)
        scores = torch.einsum("bqhd,bkhd->bqkh", qb, kb) * w_intra
        num_intra = torch.einsum("bqkh,bkhd->bqhd", scores, vb)
        den_intra = scores.sum(dim=2)  # (b, Q, h): q . (the weighted k sum)

        w_state = _clamp_exp(state_lw - m_i)  # (b, Q, h)
        num_state = torch.einsum("bqhd,bhde->bqhe", qb, C_prev) * w_state[..., None]
        den_state = torch.einsum("bqhd,bhd->bqh", qb, n_prev) * w_state

        num = num_intra + num_state
        den = torch.abs(den_intra + den_state)
        # clamped: exp(-m) overflows to inf on a fully masked (padded) row
        floor = torch.exp(torch.clamp(-m_i, -60.0, 60.0))
        ys.append(num / torch.maximum(den, floor)[..., None])

        # the state carried to the end of this chunk
        src = Ftotb[:, None, :] - Fb + lib  # (b, Q, h)
        m_src = torch.maximum(src, src.new_tensor(_NEG)).amax(dim=1)
        m_new = torch.maximum(Ftotb + m_prev, m_src)
        w_carry = _clamp_exp(Ftotb + m_prev - m_new)
        w_inj = _clamp_exp(src - m_new[:, None, :])
        C_prev = C_prev * w_carry[..., None, None] + torch.einsum(
            "bqhd,bqhe->bhde", w_inj[..., None] * kb, vb)
        n_prev = n_prev * w_carry[..., None] + torch.einsum("bqh,bqhd->bhd", w_inj, kb)
        m_prev = m_new
    return torch.stack(ys, dim=1).reshape(b, t, h, dv)


def _rank_block(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(w, c0, h0, hl, dv): this rank's block of the inner width ``din = 2
    d_model`` under the active rules, ``w`` columns from ``c0`` (all of them
    where ``ssm_inner`` is not split), and the heads it runs: ``hl`` heads
    from ``h0``, ``dv`` value columns a head.  A block of whole heads runs
    them (dv = dk); a block inside one head (more model ranks than heads:
    xlstm-350m's 4 heads of 512 at TP 16) runs that head's ``w`` value
    columns (dv = w); a block straddling two heads raises ``ValueError``."""
    din, h = 2 * cfg.d_model, cfg.n_heads
    dk = din // h
    w, c0 = sharding.local_block(din, "ssm_inner", "mlstm/w_q")
    if w % dk == 0:
        return w, c0, c0 // dk, w // dk, dk
    if dk % w == 0:
        return w, c0, c0 // dk, 1, w
    raise ValueError(f"{cfg.name}: a model rank's {w} columns of mLSTM's {din} straddle its "
                     f"heads of {dk}")


def mlstm_forward(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, D).

    Under rules that split ``ssm_inner`` over the model axis (the
    reference's ``constrain(xb, "batch", None, "ssm_inner")``) the rank
    holds a column block of ``w_up``, ``w_q``, ``w_k``, ``w_v``, ``w_o`` and
    the matching rows of ``w_down`` (:func:`_rank_block`).  ``w_up``'s block
    lies anywhere in ``xb | gb`` (at TP 2 rank 0 holds ``xb``, rank 1
    ``gb``), so ``x`` enters through ``grad_reduce_boundary`` and the rank's
    up-projection is gathered whole (``tp_gather``, partial: an all-gather
    of B x S x 4D a layer, its backward an all-reduce of the same).  The
    rank's q, k, v columns run its heads; a rank holding part of one head
    gathers q and k whole (B x S x 2D each, both ways), since ``q . k``
    and ``q . n`` contract the head's whole ``dk``, while its value and
    output columns stay its own.  The replicated gates ``w_i`` / ``w_f``
    read the whole ``xb``, and they and ``norm`` (a rank's columns of it)
    sum their gradients over the model ranks (``grad_reduce_boundary``: an
    all-reduce of 2 x 2D x H + 2D elements in the backward).
    The RMSNorm over ``din`` sums its squares over the model ranks
    (``model_sum``), and ``w_down``'s rows give a partial output summed by
    ``constrain`` (an all-reduce of B x S x D)."""
    b, s, d = x.shape
    din, h = 2 * d, cfg.n_heads
    dk = din // h
    w, c0, h0, hl, dv = _rank_block(cfg)
    tp = w != din
    w_i, w_f, scale = params["w_i"], params["w_f"], params["norm"]["scale"]
    if tp:
        x = sharding.grad_reduce_boundary(x)
        w_i, w_f, scale = (sharding.grad_reduce_boundary(t) for t in (w_i, w_f, scale))
        up = sharding.tp_gather(x @ params["w_up"], -1, partial=True)
    else:
        up = x @ params["w_up"]
    xb, gb = torch.chunk(up, 2, dim=-1)  # main branch / output-gate branch

    q, k = xb @ params["w_q"], xb @ params["w_k"]
    if dv != dk:  # part of one head: its whole q and k
        q, k = (t.reshape(b, s, h, dk)[:, :, h0:h0 + 1]
                for t in sharding.tp_gather((q, k), -1, partial=True))
    q, k = q.reshape(b, s, hl, dk), k.reshape(b, s, hl, dk)
    v = (xb @ params["w_v"]).reshape(b, s, hl, dv)
    ig = (xb @ w_i)[..., h0:h0 + hl]
    fg = (xb @ w_f)[..., h0:h0 + hl] + 3.0  # forget-bias init

    pad = (-s) % CHUNK
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad), value=_NEG)
        fg = F.pad(fg, (0, 0, 0, pad))

    y = _mlstm_parallel(q, k, v, ig, fg)[:, :s]
    y = y.reshape(b, s, w).to(x.dtype)
    if tp:
        y = rmsnorm_split(scale.narrow(0, c0, w), y, din, cfg.norm_eps)
    else:
        y = rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * F.silu(gb @ params["w_o"])
    y = y @ params["w_down"]
    return sharding.constrain(y) if tp else y


def mlstm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: MlstmCache) -> Tuple[torch.Tensor, MlstmCache]:
    """One position (B, 1, D) -> (y, the new cache); the given cache is
    left as it was.  Under rules that split ``ssm_inner`` the cache is
    whole on every model rank (``launch.partition.cache_shardings``): the
    rank's up-projection and its q, k, v columns are gathered whole
    (``tp_gather``: B x 4D and B x 6D floats), every rank updates the whole
    (C, n, m) and normalises the whole output as one rank does, then takes
    its columns through ``w_o`` and its rows of ``w_down``, the partial
    output summed by ``constrain``."""
    b = x.shape[0]
    din, h = 2 * cfg.d_model, cfg.n_heads
    dk = din // h
    w, c0, *_ = _rank_block(cfg)
    tp = w != din
    up = x @ params["w_up"]
    if tp:
        up = sharding.tp_gather(up, -1, partial=True)
    xb, gb = torch.chunk(up[:, 0], 2, dim=-1)
    q, k, v = xb @ params["w_q"], xb @ params["w_k"], xb @ params["w_v"]
    if tp:
        q, k, v = sharding.tp_gather((q, k, v), -1, partial=True)
    q = q.reshape(b, h, dk).float() * dk**-0.5
    k = k.reshape(b, h, dk).float()
    v = v.reshape(b, h, dk).float()
    logi = (xb @ params["w_i"]).float()
    logf = F.logsigmoid((xb @ params["w_f"]).float() + 3.0)

    m_new = torch.maximum(logf + cache.m, logi)
    wc = _clamp_exp(logf + cache.m - m_new)
    wi = _clamp_exp(logi - m_new)
    C = cache.C * wc[..., None, None] + wi[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = cache.n * wc[..., None] + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(torch.clamp(-m_new, -60.0, 60.0)))
    y = (num / den[..., None]).reshape(b, 1, din).to(x.dtype)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)[..., c0:c0 + w]
    y = y * F.silu(gb[:, None, :] @ params["w_o"])
    y = y @ params["w_down"]
    return (sharding.constrain(y) if tp else y), MlstmCache(C=C, n=n, m=m_new,
                                                            length=cache.length + 1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    return {
        "w_x": dense_init(gen, d, 4 * d, dtype),  # i, f, z, o from the input
        "w_h": dense_init(gen, d, 4 * d, dtype),  # recurrent
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=gen.device),
        "norm": init_norm(d, dtype, gen.device),
        "w_up": dense_init(gen, d, 2 * d, dtype),  # post-FFN (pf 4/3 approx 2x gated)
        "w_down": dense_init(gen, d, d, dtype),
    }


class SlstmCache(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D)
    m: torch.Tensor  # (B, D)
    length: torch.Tensor


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> SlstmCache:
    z = lambda: torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SlstmCache(c=z(), n=z(), h=z(),
                      m=torch.full((batch, cfg.d_model), _NEG, dtype=torch.float32,
                                   device=device),
                      length=torch.zeros((batch,), dtype=torch.int32, device=device))


def _slstm_cell(w_h: torch.Tensor, bias: torch.Tensor, gx_t: torch.Tensor, state, dtype):
    """One exponential-gated sLSTM step (stabilised), given the input half
    of the gates ``gx_t = x_t W_x`` (B, 4D) in the compute ``dtype``."""
    c, n, h, m = state
    gates = gx_t.float() + (h.to(dtype) @ w_h).float() + bias
    i_l, f_l, z_l, o_l = torch.chunk(gates, 4, dim=-1)
    logf = F.logsigmoid(f_l)
    m_new = torch.maximum(logf + m, i_l)
    i_s = _clamp_exp(i_l - m_new)
    f_s = _clamp_exp(logf + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_l)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_l) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_weights(params: dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(w_x, w_h, w_up) whole.  Under rules that split ``ssm_inner`` a rank
    holds a column block of each, which cuts across the gates ``i | f | z |
    o`` and ``g | u`` (at TP 2 rank 0 holds ``i, f``, rank 1 ``z, o``): the
    three are gathered once a call (``tp_gather``, replicated: one
    all-gather of 10 D^2 elements, its backward this rank's block of the
    gradient with no collective), and every model rank runs the recurrence
    whole.  Gathering the gates instead would cost a collective a time
    step (4096 a layer in a ``train_4k`` cell)."""
    ws = params["w_x"], params["w_h"], params["w_up"]
    if sharding.split("ssm_inner")[0] == 1:
        return ws
    return sharding.tp_gather(ws, -1, partial=False)


def _slstm_out(params: dict, cfg: ModelConfig, w_up: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """The norm and the gated FFN; under rules that split ``ssm_inner``,
    ``w_down``'s rows are the rank's, so the replicated ``gelu(g) * u``
    enters through ``grad_reduce_boundary`` before the rank takes its
    columns, and the partial output is summed by ``constrain`` (an
    all-reduce of B x S x D)."""
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    g, u = torch.chunk(y @ w_up, 2, dim=-1)
    hu = F.gelu(g, approximate="tanh") * u
    n, _ = sharding.split("ssm_inner")
    if n == 1:
        return hu @ params["w_down"]
    rows, r0 = sharding.local_block(cfg.d_model, "ssm_inner", "slstm/w_down")
    hu = sharding.grad_reduce_boundary(hu).narrow(-1, r0, rows)
    return sharding.constrain(hu @ params["w_down"])


def slstm_forward(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, D); on a model rank the recurrence runs whole
    (:func:`_slstm_weights`), ``w_down`` row-parallel (:func:`_slstm_out`)."""
    b, s, d = x.shape
    w_x, w_h, w_up = _slstm_weights(params)
    gx = x @ w_x  # (B, S, 4D): every position's input half at once
    z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    state = (z, z, z, torch.full((b, d), _NEG, dtype=torch.float32, device=x.device))
    hs = []
    for t in range(s):
        state = _slstm_cell(w_h, params["b"], gx[:, t], state, x.dtype)
        hs.append(state[2])
    return _slstm_out(params, cfg, w_up, torch.stack(hs, dim=1).to(x.dtype))


def slstm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: SlstmCache) -> Tuple[torch.Tensor, SlstmCache]:
    """One position (B, 1, D) -> (y, the new cache); on a model rank the
    whole cache's step, as :func:`slstm_forward`'s."""
    w_x, w_h, w_up = _slstm_weights(params)
    c, n, h, m = _slstm_cell(w_h, params["b"], x[:, 0] @ w_x, tuple(cache[:4]), x.dtype)
    out = _slstm_out(params, cfg, w_up, h[:, None, :].to(x.dtype))
    return out, SlstmCache(c=c, n=n, h=h, m=m, length=cache.length + 1)
