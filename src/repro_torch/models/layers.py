"""Foundational layers: norms, RoPE, embeddings, MLPs, initializers.

Port of ``repro/models/layers.py``.  Functional style, as the reference:
``init_*`` builds a dict of tensors, the apply functions are pure.  Under
active sharding rules (:mod:`repro_torch.dist.sharding`) the parameters are
this rank's blocks: :func:`mlp` is column-parallel on ``w_gate`` /
``w_up`` and row-parallel on ``w_down``, its output summed over the model
axis; :func:`embed` looks up the rank's vocabulary rows and sums the
lookups over the model axis; :func:`unembed` gives the rank's block of
the logits.  Without rules, or on one model rank, they are the reference's
functions on whole tensors.  Initializers draw
from an explicit ``torch.Generator`` on the generator's device, so the port
gives other numbers than the reference from the same seed: parity tests
carry the reference's parameters across (``repro_torch.interop``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import sharding

# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


class ShapeGenerator:
    """Stands in for a ``torch.Generator`` where only shapes are wanted
    (:mod:`repro_torch.launch.specs`): its device is ``meta``, so every
    ``init_*`` given it draws nothing and builds ``meta`` tensors of the
    shapes and dtypes it would draw."""

    device = torch.device("meta")


def _truncated_normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """N(0, 1) truncated to [-3, 3], times ``std``, drawn in float32 on the
    generator's device and cast to ``dtype`` (the reference's order); a
    :class:`ShapeGenerator` draws nothing."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    """Truncated-normal fan-in init (LLaMA-style 1/sqrt(d_in)), (d_in, d_out)."""
    return _truncated_normal(gen, (d_in, d_out), d_in**-0.5, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return _truncated_normal(gen, (vocab, d), d**-0.5, dtype)


# --------------------------------------------------------------------------
# norms (fp32 inside, as the reference)
# --------------------------------------------------------------------------


def init_norm(d: int, dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def rmsnorm_split(scale: torch.Tensor, x: torch.Tensor, dim: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """:func:`rmsnorm` over a last dimension of ``dim`` whose columns the
    model ranks split: ``x`` and ``scale`` are this rank's columns, and the
    sum of squares is summed over the model axis (``sharding.model_sum``)."""
    dtype = x.dtype
    x = x.float()
    var = sharding.model_sum(torch.sum(x * x, dim=-1, keepdim=True)) / dim
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-5):
    return rmsnorm(params, x, eps) if kind == "rmsnorm" else layernorm(params, x, eps)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer.  The split-half
    rotation of the reference: (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)  # (Dh/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table (n_pos, d) in float32: sines of
    the first half, cosines of the second, frequencies 10000^(-i / (half -
    1)) as the reference divides them."""
    half = d // 2
    log_base = torch.tensor(10000.0, device=device).log()
    freqs = torch.exp(-log_base * torch.arange(half, device=device) / (half - 1))
    args = torch.arange(n_pos, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# --------------------------------------------------------------------------
# MLP family: GLU (SwiGLU / GeGLU, 3 matrices) and plain (2 matrices)
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype, variant: str = "glu") -> dict:
    p = {"w_up": dense_init(gen, d, d_ff, dtype), "w_down": dense_init(gen, d_ff, d, dtype)}
    if variant == "glu":
        p["w_gate"] = dense_init(gen, d, d_ff, dtype)
    return p


def _activation(act: str):
    return F.silu if act == "silu" else (lambda v: F.gelu(v, approximate="tanh"))


def mlp(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The MLP; under rules that shard ``mlp``, this rank's block of d_ff,
    its partial sum reduced over the model axis (the reference's bf16 TP
    reduce after ``w_down``)."""
    actfn = _activation(act)
    tp = sharding.split("mlp")[0] > 1
    if tp:
        x = sharding.grad_reduce_boundary(x)
    up = x @ params["w_up"]
    if "w_gate" in params:  # GLU family
        h = actfn(x @ params["w_gate"]) * up
    else:  # plain 2-matrix MLP (granite / minitron / whisper)
        h = actfn(up)
    out = h @ params["w_down"]
    return sharding.constrain(out) if tp else out


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab_padded: int, d: int, dtype, tie: bool) -> dict:
    p = {"table": embed_init(gen, vocab_padded, d, dtype)}
    if not tie:
        p["unembed"] = dense_init(gen, d, vocab_padded, dtype)
    return p


def embed(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``; under rules that shard ``vocab``,
    the ids outside this rank's rows look up zeros and the lookups are
    summed over the model axis (each id has one owner)."""
    table = params["table"]
    n, _ = sharding.split("vocab")
    if n == 1:
        return table[tokens].to(dtype)
    rows, v0 = sharding.local_block(table.shape[0] * n, "vocab", "embed/table")
    local = tokens - v0
    mine = (local >= 0) & (local < rows)
    x = table[torch.where(mine, local, 0)] * mine[..., None].to(table.dtype)
    return sharding.constrain(x.to(dtype))


def unembed(params: dict, x: torch.Tensor, tie: bool) -> torch.Tensor:
    """The logits (..., V); under rules that shard ``vocab``, this rank's
    block of them (its rows of ``table``, or columns of ``unembed``)."""
    x = sharding.grad_reduce_boundary(x) if sharding.split("vocab")[0] > 1 else x
    if tie:
        return x @ params["table"].T
    return x @ params["unembed"]
