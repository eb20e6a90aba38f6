"""The LM parameters' partition specs, and each rank's blocks of a tree.

Port of the spec half of ``repro/launch/partition.py``, kept here so that
the models, the optimizer and checkpoints can read it without the launcher.
Name-based rules over the parameter-tree paths give every leaf a spec
derived from what the tensor *is* (attention projection, expert weight,
vocab table, ...), resolved against the active per-arch sharding rules
(:func:`repro_torch.dist.sharding.rules_for_arch` handles non-divisible
fallbacks).  A spec is a tuple with one entry a leading dimension: the
physical mesh axis (or tuple of axes) the dimension is split over, or
``None``; dimensions past its end are replicated, and ``()`` is a leaf
replicated whole — the reference's ``PartitionSpec`` as a plain tuple.

The reference hands GSPMD global arrays and these specs; the port's ranks
each hold their block of every leaf: :func:`shard_tree` cuts it from the
global tensor, :func:`gather_tree` puts the global tensor back together
over the axes the leaf is split on, and :class:`ShardedLayout` carries a
(mesh, spec tree) pair to :mod:`repro_torch.ckpt.checkpoint` as its
``plan=``.
"""

from __future__ import annotations

import math
import re
from typing import Any, NamedTuple, Tuple

import torch

from .sharding import resolve_axis

Spec = Tuple[Any, ...]


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and NamedTuples
    (a NamedTuple's path part is its field name); ``None`` stays ``None``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (a spec is a tuple
    leaf of the spec tree); ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_zip_map(fn, t, s) for t, s in zip(tree, specs)))
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


# (regex on path, logical axes for the trailing dims). Leading unmatched dims
# (e.g. the stacked-layer axis) are replicated.  First match wins.
PARAM_RULES = [
    (r"embed/table$", ("vocab", None)),
    (r"embed/unembed$", (None, "vocab")),
    (r"attn/wq$", (None, "heads")),
    (r"attn/wk$", (None, "kv_heads")),
    (r"attn/wv$", (None, "kv_heads")),
    (r"attn/wo$", ("heads", None)),
    (r"attn/w_dq$", (None, None)),
    (r"attn/w_uq$", (None, "heads")),
    (r"attn/w_dkv$", (None, None)),
    (r"attn/w_krope$", (None, None)),
    (r"attn/w_uk$", (None, "heads")),
    (r"attn/w_uv$", (None, "heads")),
    (r"attn/w_q$", (None, "heads")),
    (r"mlp/w_gate$", (None, "mlp")),
    (r"mlp/w_up$", (None, "mlp")),
    (r"mlp/w_down$", ("mlp", None)),
    (r"shared/w_gate$", (None, "mlp")),
    (r"shared/w_up$", (None, "mlp")),
    (r"shared/w_down$", ("mlp", None)),
    (r"moe/router$", (None, None)),
    (r"moe/router_bias$", (None,)),
    (r"moe/w_gate$", ("experts", "fsdp", None)),
    (r"moe/w_up$", ("experts", "fsdp", None)),
    (r"moe/w_down$", ("experts", None, "fsdp")),
    (r"mamba/in_proj$", ("fsdp", None)),
    (r"mamba/out_proj$", (None, "fsdp")),
    (r"mamba/conv_[wb]$", None),  # tiny: replicate
    (r"(mlstm|slstm)/w_(up|q|k|v|o|x|h)$", (None, "ssm_inner")),
    (r"(mlstm|slstm)/w_down$", ("ssm_inner", None)),
    (r"(mlstm|slstm)/w_[ifb]$", None),
]


def spec_for_param(path: str, ndim: int, rules, names) -> Spec:
    for pat, axes in PARAM_RULES:
        if re.search(pat, path):
            if axes is None:
                return ()
            resolved = tuple(resolve_axis(a, rules, names) for a in axes)
            return (None,) * (ndim - len(resolved)) + resolved
    return ()  # norms, biases, scalars: replicated


def param_shardings(mesh, params, rules) -> Any:
    """The spec tree of a parameter tree (tensors, or anything with ``.shape``)."""
    names = tuple(mesh.axis_names)
    return _map_with_path(
        lambda path, leaf: spec_for_param(_path_str(path), len(leaf.shape), rules, names),
        params)


def leaf_specs(mesh, params, rules) -> list:
    """The spec of every leaf of a parameter tree, in the tree's order
    (``lm.tree_leaves``'s, the order of ``steps.grads_of``'s gradients)."""
    names, out = tuple(mesh.axis_names), []
    _map_with_path(lambda path, leaf: out.append(
        spec_for_param(_path_str(path), len(leaf.shape), rules, names)), params)
    return out


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a leaf of ``spec`` is split over."""
    return tuple(a for entry in spec for a in _axes(entry))


def _block(mesh, entry) -> Tuple[int, int]:
    """(ranks, this rank's block) along a spec entry; several axes are
    taken row-major, as the reference's mesh lays them out."""
    n, i = 1, 0
    for a in _axes(entry):
        n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
    return n, i


def shard_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec``, a
    contiguous copy (so that the global tensor can go); ``ValueError`` when
    the ranks do not divide a split dimension."""
    for dim, entry in enumerate(spec):
        n, i = _block(mesh, entry)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of a {tuple(t.shape)} leaf does not divide over "
                             f"{n} ranks of {entry}")
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t.contiguous().clone()


def gather_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The global tensor of this rank's block ``t`` under ``spec``, gathered
    over each axis it is split on (innermost axis first); every rank of
    those axes must call it."""
    from .compat import gather_cat

    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            t = gather_cat(t, mesh.group(a), dim)
    return t


def shard_tree(tree, specs, mesh):
    """This rank's block of every leaf of a global ``tree`` (:func:`shard_leaf`)."""
    return _zip_map(lambda t, s: shard_leaf(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """The global tensor of every leaf of this rank's ``tree``
    (:func:`gather_leaf`); a collective over the mesh."""
    return _zip_map(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


class ShardedLayout(NamedTuple):
    """A tree's partition on a mesh, in the shape of a distributed
    ``ExecutionPlan`` as :func:`repro_torch.ckpt.checkpoint.save` and
    ``restore`` read it (``plan=``): the checkpoint holds the global tree,
    and each rank keeps its blocks of it."""

    mesh: Any
    specs: Any  # the spec tree, shaped like the tree

    @property
    def is_distributed(self) -> bool:
        return math.prod(self.mesh.axis_sizes) > 1

    def global_state(self, tree):
        return gather_tree(tree, self.specs, self.mesh)

    def local_state(self, tree):
        return shard_tree(tree, self.specs, self.mesh)
