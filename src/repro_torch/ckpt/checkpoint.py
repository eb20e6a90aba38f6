"""Fault-tolerant checkpointing: atomic save and restart of solver state.

Port of ``repro/ckpt/checkpoint.py``, with the same on-disk format, so a
checkpoint either package writes restores in the other:

  * Layout: ``<dir>/step_<step:010d>/arrays.npz`` + ``meta.json``; each
    leaf is one npz array keyed by its path in the tree — NamedTuple field
    names, dict keys and list indices joined by ``|``.
  * Atomicity: write to ``<dir>/.tmp.*`` then ``os.replace`` — a crash
    mid-save never corrupts the latest checkpoint.
  * Integrity: ``meta.json`` carries a content checksum; a mismatch fails
    loudly at restore.
  * Order and retention: ``step_*`` directories are ordered numerically
    (padded or not); the ``keep`` newest are kept, never pruning the step
    being published.

Leaves are saved from any device (copied to the host) and restored onto
the device of the matching leaf of ``like``, or onto ``device=``.

On a mesh (``plan=`` a distributed execution plan, the counterpart of the
reference's ``restore(..., shardings=)``) the checkpoint holds the *global*
state: every rank takes part in gathering its rows and signals, rank 0
alone writes the file, and on restore every rank reads it and keeps its
own blocks, so a checkpoint crosses between meshes and between the
packages.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

SEP = "|"  # path-key separator inside the npz


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container, in the reference's flattening
    order (dicts by sorted key); ``None`` for a leaf."""
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _leaf_paths(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        yield SEP.join(prefix), tree
        return
    for key, child in kids:
        yield from _leaf_paths(child, prefix + (key,))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaf_paths(tree)}


def _rebuild(like, leaves: Dict[str, torch.Tensor], prefix=()):
    kids = _children(like)
    if kids is None:
        return leaves[SEP.join(prefix)]
    built = [_rebuild(child, leaves, prefix + (key,)) for key, child in kids]
    if _is_namedtuple(like):
        return type(like)(*built)
    if isinstance(like, dict):
        return {k: v for k, v in zip(sorted(like), built)}
    return type(like)(built)


def _checksum(arrays: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes()[:65536])
    return h.hexdigest()[:16]


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None, keep: int = 3,
         plan=None) -> str:
    """Atomically persist ``tree`` for ``step``; returns the final path.

    With a distributed ``plan`` every rank must call this: the state is
    gathered to its global arrays, rank 0 writes, and all ranks return once
    the checkpoint is published.
    """
    if plan is not None and plan.is_distributed:
        tree = plan.global_state(tree)
        path = _save(ckpt_dir, step, tree, extra, keep) if dist.get_rank() == 0 else \
            os.path.join(ckpt_dir, f"step_{step:010d}")
        dist.barrier()
        return path
    return _save(ckpt_dir, step, tree, extra, keep)


def _save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict], keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _flatten(tree)
    meta = {
        "step": int(step),
        "checksum": _checksum(arrays),
        "extra": extra or {},
        "keys": sorted(arrays),
    }
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".tmp.", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # retention never removes the step just published, even when its number
    # is below ``keep`` older checkpoints (a restart that re-saves an early
    # step after later ones already exist)
    _prune(ckpt_dir, keep, protect=int(step))
    return final


def _step_dirs(ckpt_dir: str):
    """``(step, name)`` for every step directory, ordered *numerically*.

    Names are parsed, not sorted lexically: a lexical sort puts ``step_9``
    after ``step_10`` and after every zero-padded name.  Non-numeric
    ``step_*`` names are ignored.
    """
    out = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_"):
            continue
        try:
            s = int(d.split("_", 1)[1])
        except ValueError:
            continue
        out.append((s, d))
    out.sort()
    return out


def _prune(ckpt_dir: str, keep: int, protect: Optional[int] = None) -> None:
    if keep <= 0:
        return
    for s, d in _step_dirs(ckpt_dir)[:-keep]:
        if protect is not None and s == protect:
            continue  # never touch the checkpoint currently being published
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _dir_for_step(ckpt_dir: str, step: int) -> str:
    """Resolve a step number to its on-disk directory (padded or not)."""
    padded = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.isdir(padded):
        return padded
    for s, d in _step_dirs(ckpt_dir):
        if s == step:
            return os.path.join(ckpt_dir, d)
    return padded  # keep the canonical name in the FileNotFoundError


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        s
        for s, d in _step_dirs(ckpt_dir)
        if os.path.exists(os.path.join(ckpt_dir, d, "meta.json"))
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int], like: Any, device=None,
            plan=None) -> Tuple[int, Any]:
    """Restore ``step`` (``None`` = the latest) into the structure of ``like``.

    Each leaf keeps its saved dtype and goes to ``device``, or, when that is
    ``None``, to the device of the matching tensor leaf of ``like`` (the CPU
    for a non-tensor leaf).  With a distributed ``plan`` the file holds the
    global state and each rank keeps its own blocks of it.  Raises
    ``IOError`` on a checksum mismatch.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _dir_for_step(ckpt_dir, step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    if _checksum(arrays) != meta["checksum"]:
        raise IOError(f"checksum mismatch in {path} — corrupt checkpoint")

    leaves = {}
    for key, leaf_like in _leaf_paths(like):
        if device is not None:
            dev = torch.device(device)
        else:
            dev = leaf_like.device if isinstance(leaf_like, torch.Tensor) else torch.device("cpu")
        leaves[key] = torch.from_numpy(arrays[key]).to(dev)
    tree = _rebuild(like, leaves)
    if plan is not None and plan.is_distributed:
        tree = plan.local_state(tree)
    return meta["step"], tree


def solver_checkpoint_cb(ckpt_dir: str, plan=None):
    """save_cb for :func:`repro_torch.core.solvers.solve_checkpointed`."""

    def cb(step, state):
        save(ckpt_dir, step, state, plan=plan)

    return cb
