"""Named-axis sharding rules, and the collectives they put into the LM.

Port of ``repro/dist/sharding.py``.  The rules are the reference's: the
models name *logical* axes ("batch", "heads", "mlp", ...) and this module
maps them to the physical mesh axes ("pod", "data", "model"):

    DEFAULT_RULES        the production mapping (TP on "model", DP over
                         ("pod", "data"), FSDP for the MoE expert weights)
    rules_for_arch       a per-arch copy of DEFAULT_RULES with the shardings
                         that do not divide the model dimension dropped (a
                         4-kv-head model on a 16-way model axis replicates)
    activate_rules       makes (rules, mesh) current for the model code
    current_rules        the active (rules, mesh), or (None, None)

The reference's GSPMD inserts the collectives of tensor parallelism where
the models fix an activation's layout.  The port runs one process a rank
and puts them in by hand, over the process group of the mesh's ``model``
axis (Megatron's two conjugate operators):

    constrain            an all-reduce in the forward, the identity in the
                         backward: applied to a row-parallel product's
                         output (``wo``, ``w_down``, the vocab-parallel
                         embedding, the experts' combine), this rank's
                         partial sum, it gives the sum every model rank
                         holds (the reference's ``constrain(y, "batch",
                         None, "embed")``, where GSPMD reduces)
    grad_reduce_boundary the identity in the forward, an all-reduce of the
                         cotangent in the backward: applied to the input of
                         a tensor-parallel block (attention, MLP, the
                         experts, the loss head), whose column-parallel
                         products give each rank a partial cotangent

The reference marks the boundary at a layer's input, before its norm,
which GSPMD reads as a layout; an all-reduce placed there by hand would add
the replicated residual's cotangent once per model rank, so the port puts
it at each block's input, after the norm.  Both are the identity when no
rules are active or when the model axis has one rank, as the reference's
annotations are (``sharding.py:138-146`` there).

Mamba-2 and xLSTM (the ``ssm_inner`` rule) add two: :func:`model_sum`, an
all-reduce both ways (a norm's sum of squares over a dimension the ranks
split), and :func:`tp_gather`, an all-gather over ``model`` whose backward
cuts this rank's block of the cotangent, summed over the ranks first when
each rank's use of the whole tensor is a part of it.

The data axis: :func:`fsdp_gather` gathers a weight sharded over ``data``
(the MoE experts' ``d_model``) for use and returns its gradient summed over
the data ranks and cut back to this rank's block (all-reduce and slice:
``reduce_scatter`` is not relied on over gloo); :func:`data_gather` gathers
integer routing ids without a gradient.

Nothing here touches a process group at import time.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

# Logical axis -> physical mesh axes.  Tuples are resolved against the axes
# actually present in the mesh (so ("pod", "data") degrades to ("data",) on a
# single-pod mesh).  ``None`` = replicated.
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),  # data parallelism over pod x data
    "seq": None,  # sequence parallelism off by default
    "embed": None,  # activations replicated along d_model
    "vocab": "model",  # embedding/unembedding rows (Megatron-style)
    "heads": "model",  # attention TP on the head-flat dim
    "kv_heads": "model",
    "mlp": "model",  # feed-forward TP on d_ff
    "experts": "model",  # expert parallelism on the expert dim
    "fsdp": "data",  # MoE weight FSDP on d_model (the 671B case)
    "ssm_inner": "model",  # mamba/xlstm inner projections
}

# Logical axes whose shardability depends on a model dimension, and the
# config field that dimension comes from (see ``rules_for_arch``).
_DIVISIBILITY = (
    ("vocab", lambda cfg: cfg.vocab_padded),
    ("heads", lambda cfg: cfg.n_heads),
    ("kv_heads", lambda cfg: cfg.n_kv_heads),
    ("mlp", lambda cfg: cfg.d_ff),
    ("experts", lambda cfg: cfg.n_experts),
    ("fsdp", lambda cfg: cfg.d_model),
    ("ssm_inner", lambda cfg: cfg.d_ssm_inner),
)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: extent} of a mesh that has ``axis_names`` and
    ``axis_sizes`` (:class:`repro_torch.dist.compat.Mesh`)."""
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def extent(mesh, phys) -> int:
    """Total rank count behind a physical-axis assignment (present axes only)."""
    if phys is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(phys, tuple):
        n = 1
        for a in phys:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(phys, 1)


def rules_for_arch(cfg, mesh) -> Dict[str, Any]:
    """DEFAULT_RULES specialized to one architecture on one mesh.

    Any logical axis whose model dimension does not divide the mesh extent it
    would shard over falls back to replication (``None``), as the
    reference's does; only the mesh's axis names and sizes are read.
    """
    rules = dict(DEFAULT_RULES)
    for logical, dim_of in _DIVISIBILITY:
        n = extent(mesh, rules.get(logical))
        dim = dim_of(cfg)
        if n > 1 and (dim == 0 or dim % n != 0):
            rules[logical] = None
    return rules


def resolve_axis(logical: Optional[str], rules: Dict[str, Any], names: Tuple[str, ...]):
    """Logical name -> physical axis (or tuple) restricted to present axes."""
    if logical is None:
        return None
    phys = rules.get(logical)
    if phys is None:
        return None
    if isinstance(phys, tuple):
        present = tuple(a for a in phys if a in names)
        return present if len(present) > 1 else (present[0] if present else None)
    return phys if phys in names else None


# --------------------------------------------------------------------------
# active-rules context
# --------------------------------------------------------------------------

_ACTIVE: list = []  # stack of (rules, mesh)


@contextlib.contextmanager
def activate_rules(rules: Dict[str, Any], mesh):
    """Make (rules, mesh) current: inside, the LM runs on this rank's shards
    with the collectives of this module, outside it runs unsharded."""
    _ACTIVE.append((rules, mesh))
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_rules() -> Tuple[Optional[Dict[str, Any]], Optional[Any]]:
    return _ACTIVE[-1] if _ACTIVE else (None, None)


def is_sharded_run() -> bool:
    """Rules are active over a mesh of more than one rank."""
    rules, mesh = current_rules()
    return rules is not None and mesh is not None and extent(mesh, tuple(mesh.axis_names)) > 1


_SPLIT_AXES = (("model",), ("data",), ("pod", "data"))  # what the port shards over


def split(logical: str) -> Tuple[int, int]:
    """(ranks, this rank's index) of the mesh axis the active rules shard
    ``logical`` over; (1, 0) when it is replicated or no rules are active.
    ``model``, ``data`` and the multi-pod batch's ``("pod", "data")`` (taken
    row-major, as the reference's mesh lays it out) are taken; a logical
    axis that resolves to anything else raises ``NotImplementedError``."""
    rules, mesh = current_rules()
    if rules is None or mesh is None:
        return 1, 0
    phys = resolve_axis(logical, rules, tuple(mesh.axis_names))
    if phys is None:
        return 1, 0
    axes = phys if isinstance(phys, tuple) else (phys,)
    if axes not in _SPLIT_AXES:
        raise NotImplementedError(f"the port shards {logical!r} over 'model', 'data' or "
                                  f"('pod', 'data'); these rules put it on {phys!r}")
    n, i = 1, 0
    for a in axes:
        n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
    return n, i


def _group(axis):
    """The active mesh's group over ``axis``, one axis or a tuple of them
    (the multi-pod batch's joint (pod, data) group)."""
    return current_rules()[1].group(axis)


def batch_axes():
    """The mesh axis (or tuple of axes) the active rules shard the batch
    over, ``None`` when it is replicated or no rules are active."""
    rules, mesh = current_rules()
    if rules is None or mesh is None:
        return None
    return resolve_axis("batch", rules, tuple(mesh.axis_names))


def model_ranks() -> int:
    """Ranks of the active mesh's ``model`` axis (1 without rules)."""
    rules, mesh = current_rules()
    if rules is None or mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.size("model")


def local_block(dim: int, logical: str, what: str) -> Tuple[int, int]:
    """(this rank's block size, its first global index) of a dimension of
    ``dim`` along ``logical`` under the active rules; raises ``ValueError``
    when the ranks do not divide it (rules_for_arch never gives that)."""
    n, i = split(logical)
    if dim % n:
        raise ValueError(f"{what}: {dim} does not divide over {n} ranks of {logical!r}")
    return dim // n, i * (dim // n)


class _AllReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def constrain(x: torch.Tensor) -> torch.Tensor:
    """``x``, this rank's partial sum of a row-parallel product, summed over
    the model axis (the reference's ``constrain(y, "batch", None, "embed")``
    there, a layout replicated on ``model``): an all-reduce in the forward,
    the identity in the backward.  The identity without active rules or on a
    model axis of one rank."""
    if model_ranks() == 1:
        return x
    return _AllReduceForward.apply(x, _group("model"))


def grad_reduce_boundary(x: torch.Tensor) -> torch.Tensor:
    """The identity in the forward; in the backward the cotangent summed
    over the model axis: ``x`` enters a tensor-parallel block, whose
    column-parallel products give each model rank part of its cotangent.
    The identity without active rules or on a model axis of one rank."""
    if model_ranks() == 1:
        return x
    return _AllReduceBackward.apply(x, _group("model"))


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model axis, an all-reduce of its bytes over the
    ``model`` group in the forward and of its cotangent's in the backward
    (:func:`constrain`, then :func:`grad_reduce_boundary`): the sum is
    replicated, but each rank's use of it is a per-rank part of its
    cotangent (the sum of squares of a norm over a dimension the ranks
    split, ``ssm_inner``).  The identity on one model rank."""
    return grad_reduce_boundary(constrain(x))


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, partial, group, index, *ts):
        from .compat import gather_cat

        ctx.dim, ctx.partial, ctx.group, ctx.index = dim, partial, group, index
        ctx.sizes = [t.shape[dim] for t in ts]
        return tuple(gather_cat(t, group, dim) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g, size in zip(gs, ctx.sizes):
            g = g.contiguous()
            if ctx.partial:
                g = g.clone()
                dist.all_reduce(g, group=ctx.group)
            out.append(g.narrow(ctx.dim, ctx.index * size, size))
        return (None, None, None, None, *out)


def tp_gather(ts, dim: int, partial: bool):
    """Every model rank's block of each tensor of ``ts`` (a tensor, or a
    tuple of them) concatenated along ``dim`` in model order: one all-gather
    over the ``model`` group a tensor, of its block's bytes times the ranks.
    The backward returns this rank's block of the cotangent: summed over the
    model ranks first (an all-reduce of the gathered tensor's bytes) when
    ``partial``, for a consumer whose use on each rank gives a part of the
    cotangent (a rank's columns of a product, its heads); as it is when the
    consumer is replicated, every rank computing the same function of the
    whole tensor.  The identity on one model rank."""
    single = isinstance(ts, torch.Tensor)
    ts = (ts,) if single else tuple(ts)
    if model_ranks() == 1:
        return ts[0] if single else ts
    out = _GatherCat.apply(dim, partial, _group("model"), current_rules()[1].index("model"), *ts)
    return out[0] if single else out


def reduce_max(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The elementwise max over ``axis``'s ranks, without a gradient."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(axis))
    return out


def reduce_min(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The elementwise min over ``axis``'s ranks, without a gradient."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=_group(axis))
    return out


def model_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` of every model rank concatenated along ``dim`` in model order,
    without a gradient (the vocabulary blocks of the serving logits)."""
    if model_ranks() == 1:
        return t
    from .compat import gather_cat

    return gather_cat(t.detach(), _group("model"), dim)


def data_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``t`` of every data rank (of the batch's axes: (pod, data) on the
    multi-pod mesh) concatenated along ``dim`` in data order, without a
    gradient (routing ids); ``t`` itself on one data rank."""
    n, _ = split("batch")
    if n == 1:
        return t
    from .compat import gather_cat

    return gather_cat(t.detach(), _group(batch_axes()), dim)


def fsdp_gather(w: torch.Tensor, dim: int) -> torch.Tensor:
    """A weight sharded along ``dim`` by the ``fsdp`` rule, gathered whole
    over the data axis; its gradient comes back summed over the data ranks
    and cut to this rank's block.  ``w`` itself when ``fsdp`` is replicated."""
    n, i = split("fsdp")
    if n == 1:
        return w
    return _GatherCat.apply(dim, True, _group("data"), i, w)[0]
