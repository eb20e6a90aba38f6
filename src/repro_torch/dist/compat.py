"""Ranks, meshes and process groups for the distributed port.

The reference holds global arrays and lets ``shard_map`` scatter them over a
JAX mesh.  The port runs one process per rank, and each rank holds only its
own blocks; a :class:`Mesh` names the axes (``("model",)`` or
``("data", "model")``), gives this rank's coordinate on each and one
process group per axis, over which the collectives of
:mod:`repro_torch.dist.fft` run.  Ranks are laid out row-major over the
axes: global rank ``r = d * M + m`` on a ``D x M`` mesh.

Three ways to start the ranks:

* under ``torchrun``: NCCL, each rank on ``cuda:LOCAL_RANK`` (gloo with
  ``device="cpu"``);
* :func:`spawn_fake_devices` ``(n, fn, *args, device=...)``: ``n`` gloo
  ranks in child processes that all hold their tensors on the one
  ``device`` (the CPU, or one card shared by every rank — NCCL refuses two
  ranks on one GPU; gloo stages CUDA tensors through the host);
* world size 1 needs no launcher: an in-process group over a ``HashStore``,
  NCCL on the card;
* :func:`init_dry_run` ``(world, rank)``: one rank of a world of any size on
  torch's fake process group, its tensors on ``meta``: its collectives
  return at once and move nothing, so one process walks one rank of a
  256- or 512-rank production mesh with no memory and no peers (the dry
  runs of :mod:`repro_torch.launch.dryrun`; the reference's placeholder
  devices).

A world size that is not the product of the mesh shape raises; the mesh is
never shrunk and never moved to the CPU.

A hierarchical mesh (:func:`make_hier_mesh`) has the axes ``("data",
"host", "device")`` and a transform axis that factors over the ``(host,
device)`` pair: ``size``, ``index`` and ``group`` take that pair as one
axis of ``H x D`` ranks, sharded *device-major* (the rank at host ``h``,
device ``d`` holds block ``d * H + h``), the order in which an intra-host
all-to-all is the right first stage of the two-stage exchange
(:mod:`repro_torch.dist.fft`).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import pickle
import shutil
import tempfile
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

MODEL_AXIS = "model"  # the mesh axis a signal's rows and columns shard over
DATA_AXIS = "data"  # the mesh axis a leading batch of signals shards over
HOST_AXIS = "host"  # the slow tier of a hierarchical mesh (between hosts)
DEVICE_AXIS = "device"  # the fast tier of a hierarchical mesh (within a host)

_RANK_DEVICE: Optional[torch.device] = None  # set when this process joins a group
_MESHES: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a named device mesh."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...]  # this rank's coordinate on each axis
    groups: tuple  # one process group per axis, ranks ordered by coordinate
    device: torch.device  # where this rank's tensors live
    pair_groups: dict = dataclasses.field(default_factory=dict)  # (host, device) -> group

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh axis {name!r} not in {self.axis_names}")
        return self.axis_names.index(name)

    def size(self, name) -> int:
        """The extent of axis ``name``; of a (host, device) pair, H x D."""
        if isinstance(name, tuple):
            return math.prod(self.size(a) for a in name)
        return self.axis_sizes[self._axis(name)]

    def index(self, name) -> int:
        """This rank's coordinate on axis ``name``; on a (host, device) pair
        its block ``d * H + h`` (device-major)."""
        if isinstance(name, tuple):
            host, dev = name
            return self.index(dev) * self.size(host) + self.index(host)
        return self.coords[self._axis(name)]

    def group(self, name):
        if isinstance(name, tuple):
            if name not in self.pair_groups:
                raise ValueError(f"this mesh has no joint group over {name}; build it with "
                                 f"make_hier_mesh")
            return self.pair_groups[name]
        return self.groups[self._axis(name)]

    def group_order(self, name):
        """The blocks the ranks of ``group(name)`` hold, in group-rank order:
        ``None`` where group rank and block agree.  torch orders a group's
        ranks by global rank (host-major, ``h * D + d``), and the pair's
        blocks are device-major."""
        if not isinstance(name, tuple):
            return None
        H, D = self.size(name[0]), self.size(name[1])
        if H == 1 or D == 1:
            return None
        return [(g % D) * H + g // D for g in range(H * D)]


def rank_device() -> torch.device:
    """The device this rank's tensors live on, as its launcher set it."""
    if _RANK_DEVICE is None:
        raise RuntimeError("this process has not joined a process group; call make_mesh "
                           "or init_distributed first")
    return _RANK_DEVICE


def init_distributed(device=None) -> torch.device:
    """Join the default process group, once; -> this rank's device.

    Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set) each
    rank takes ``cuda:LOCAL_RANK`` and NCCL, or the CPU and gloo when
    ``device="cpu"``.  Otherwise this process is a world of one, over an
    in-process ``HashStore``.  A CUDA device is required unless
    ``device="cpu"`` is given: nothing falls back to the CPU.
    """
    global _RANK_DEVICE
    if dist.is_initialized():
        if _RANK_DEVICE is None:
            raise RuntimeError("a process group was initialised outside repro_torch; "
                               "start the ranks with init_distributed or spawn_fake_devices")
        return _RANK_DEVICE
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    cpu = device is not None and torch.device(device).type == "cpu"
    dev = _joining_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "gloo" if cpu else "nccl"
    if launched:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    _RANK_DEVICE = dev
    return dev


def _joining_device(device) -> torch.device:
    """The device :func:`init_distributed` would give this process: the CPU
    when asked for, ``cuda:LOCAL_RANK`` under ``torchrun``, else
    ``resolve_device(device)``; raises without CUDA unless ``device="cpu"``."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return resolve_device(torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
    return resolve_device(device)


def init_dry_run(world: int, rank: int = 0) -> torch.device:
    """Join a fake process group of ``world`` ranks as ``rank``; -> ``meta``,
    the device this rank's tensors then live on.  A group this process
    joined before is left first (so one process can walk meshes of several
    sizes), with the meshes made over it.

    The fake backend is torch's own (``torch.testing._internal.distributed.
    fake_pg``, a private path imported here alone); it is named for the
    ``meta`` device too, because point-to-point batches look their backend
    up by the tensors' device.  After it, :func:`make_mesh` and
    :func:`make_hier_mesh` build any mesh of ``world`` ranks unchanged."""
    global _RANK_DEVICE
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESHES.clear()
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=rank,
                            world_size=world)
    _RANK_DEVICE = torch.device("meta")
    return _RANK_DEVICE


def world_size() -> int:
    """The ranks of this process's world: the joined group's size, else
    ``WORLD_SIZE`` under ``torchrun``, else 1 (a world of one); joins nothing."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1)) if "RANK" in os.environ else 1


def make_mesh(shape, names, device=None, pairs=()) -> Mesh:
    """A mesh of ``shape`` with axis ``names`` over the default group,
    joining it first (:func:`init_distributed`) when this process has not.
    ``pairs``: (host, device) axis pairs that also get a joint group.

    Raises ``ValueError`` when the world size is not ``prod(shape)``,
    before joining any group (and after the device check of
    :func:`init_distributed`, which raises without CUDA unless
    ``device="cpu"``).
    """
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} does not match axis names {names}")
    if not dist.is_initialized():
        _joining_device(device)
    world = world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} needs {math.prod(shape)} ranks, but the "
            f"world has {world}: start that many ranks (torchrun --nproc-per-node, or "
            f"--fake-devices) or pick a mesh of {world}"
        )
    dev = init_distributed(device)
    rank = dist.get_rank()
    pairs = tuple(tuple(p) for p in pairs)
    key = (shape, names, pairs)
    if key not in _MESHES:
        coords = _coords(rank, shape)
        groups = [_axis_group(rank, world, shape, (a,)) for a in range(len(shape))]
        joint = {p: _axis_group(rank, world, shape, tuple(names.index(a) for a in p))
                 for p in pairs}
        _MESHES[key] = Mesh(names, shape, coords, tuple(groups), dev, joint)
    return _MESHES[key]


def make_hier_mesh(data: int, host: int, device: int, on=None) -> Mesh:
    """A ``data x host x device`` mesh for the hierarchical two-stage
    transpose, with a joint group over the ``(host, device)`` transform axis.

    Ranks are laid out row-major, so the ``device`` tier is innermost: the
    ``host * device`` consecutive ranks of one data slice form ``host``
    groups of ``device`` neighbours, as consecutive ranks on one machine
    do under ``torchrun``.  ``on`` is :func:`make_mesh`'s
    ``device``.
    """
    return make_mesh((data, host, device), (DATA_AXIS, HOST_AXIS, DEVICE_AXIS),
                     device=on, pairs=((HOST_AXIS, DEVICE_AXIS),))


def _axis_group(rank: int, world: int, shape, axes):
    """This rank's group over the mesh axes ``axes`` (the other coordinates
    fixed).  Every rank creates every group, in one order (torch requires
    it); torch orders a group's ranks by global rank."""
    mine = None
    others = [i for i in range(len(shape)) if i not in axes]
    for rest in itertools.product(*(range(shape[i]) for i in others)):
        members = []
        for inner in itertools.product(*(range(shape[a]) for a in axes)):
            full = [0] * len(shape)
            for i, c in zip(others, rest):
                full[i] = c
            for a, c in zip(axes, inner):
                full[a] = c
            members.append(_rank_of(full, shape))
        g = dist.group.WORLD if world == 1 else dist.new_group(sorted(members))
        if rank in members:
            mine = g
    return mine


def _coords(rank: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        rank, c = divmod(rank, s)
        out.append(c)
    return tuple(reversed(out))


def _rank_of(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def gather_cat(t: torch.Tensor, group, dim: int, order=None) -> torch.Tensor:
    """All-gather ``t`` over ``group`` and concatenate along ``dim``, in
    group-rank order (= mesh coordinate), or in block order when ``order``
    (:meth:`Mesh.group_order`) gives each group rank's block; a group of one
    returns ``t``."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    if order is not None:
        by_block = [None] * size
        for g, block in enumerate(order):
            by_block[block] = parts[g]
        parts = by_block
    return torch.cat(parts, dim=dim)


def spawn_fake_devices(n: int, fn, *args, device="cpu") -> list:
    """Run ``fn(*args)`` on ``n`` gloo ranks in child processes; -> the
    ranks' return values, in rank order (tensors come back on the CPU).

    Every rank holds its tensors on ``device``: the CPU, or one CUDA card
    shared by all ranks (the counterpart of the reference's
    ``--fake-devices N``).  The ranks meet through a ``file://`` store in a
    fresh temporary directory, so concurrent runs never collide on a port;
    each runs one intra-op thread.  The CUDA kernels are built
    here first, so the ranks do not run ``nvcc`` at once.  A rank that
    raises ends every rank and re-raises here.
    """
    dev = resolve_device(device)  # raises for a CUDA device when there is none
    if dev.type == "cuda":
        from ..kernels import build

        build.build_all()
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        mp.spawn(_fake_rank, args=(n, fn, args, tmp, str(dev)), nprocs=n,
                 join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(o) for o in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _fake_rank(rank: int, n: int, fn, args, tmp: str, device: str) -> None:
    global _RANK_DEVICE
    torch.set_num_threads(1)  # n ranks share this machine's cores
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=n)
    _RANK_DEVICE = dev
    try:
        out = _to_cpu(fn(*args))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
