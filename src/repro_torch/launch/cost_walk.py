"""The cost walk: what one call of a function asks of the device.

The port's counterpart of ``repro/launch/hlo_analysis.py``.  The reference
lowers a block to HLO and walks the compiled program; the port has no
compiled program to read, so :func:`walk` runs the function once, on the
rank's own device and operands, under a ``TorchDispatchMode`` that sees
every aten operation, and adds up for each one

* the bytes of its tensor operands and results, each once (a view moves
  nothing and adds nothing; an allocation writes nothing and adds nothing);
* its flops: ``torch.utils.flop_counter``'s rules (matrix products,
  convolutions, attention), plus 5 N log2 N for each complex FFT of length N
  and half that for a real one, as the reference's walk reckons an FFT;
* one launch.

The kernel wrappers (``repro_torch.kernels.*.ops``) launch Triton and CUDA
C++ around the dispatcher, where the mode cannot see them: each reports its
launch, its operand and result bytes and its flops through
:func:`repro_torch.kernels.report_launch`, which only a running walk hears.
On ``meta`` tensors a wrapper reports the launch the card would make and
computes nothing, so a walk on ``meta`` operands (the dry runs) counts what
the card's would.

Every collective the mode sees (the ``c10d`` namespace: the four-step
exchange's all-to-alls and host hops, the LM's all-reduces and
all-gathers) adds its payload, the bytes of its result tensors in their own
dtype (a bf16 wire counts 2 bytes an element), to ``collective_bytes`` and
one to ``collective_counts``, under the reference's names
(``hlo_analysis.COLLECTIVES``): ``"all-reduce"``, ``"all-gather"``,
``"reduce-scatter"``, ``"all-to-all"``, and ``"collective-permute"`` for a
point-to-point ``send`` (its ``recv`` is the same hop, counted once).  A
collective adds no launch and no HBM bytes here, as before the LM's were
counted, so the tuner's numbers are the same.  ``group_bytes`` keeps the
same payloads by the global ranks of the collective's group, which is how
a dry run prices each group on its own link (:func:`repro_torch.launch.
roofline.derive`).

``peak_bytes`` is the most that the tensors the call made were holding at
once (the counterpart of the reference's
``memory_analysis().temp_size_in_bytes``): the walk sees each result
when it is made and each storage when it dies.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import kernels

# allocations: a new buffer, nothing read or written on the device
_ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                          "new_empty_strided"})
_FFTS = {"_fft_c2c": 1.0, "_fft_r2c": 0.5, "_fft_c2r": 0.5}  # flops factor per 5 N log2 N
# c10d op -> the reference's collective name; the payload is the first
# argument's tensors (the result of every one of these, the sent buffer of a send)
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "broadcast_": "broadcast",
}


@dataclasses.dataclass
class Cost:
    """What one call asked of the device (see module docstring)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    launches: int = 0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    # the global ranks of a collective's group -> {collective: payload bytes}
    group_bytes: Dict[Tuple[int, ...], Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fft_flops(name: str, args, out: torch.Tensor) -> float:
    """5 N log2 N per transform of length N (half that for a real one), N
    the real side's extent over the transformed dims."""
    real = out if name == "_fft_c2r" else args[0]
    n = math.prod(real.shape[d] for d in args[1])
    return _FFTS[name] * 5.0 * real.numel() * max(math.log2(max(n, 2)), 1.0)


def _tensors(tree) -> list:
    """The distinct tensors of ``tree``, each once."""
    out, seen = [], set()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _group_ranks(args) -> Tuple[int, ...]:
    """The global ranks of the process group among a c10d op's arguments,
    where the dispatcher hands it boxed (a ``torch.ScriptObject``); ``()``
    when there is none."""
    for a in args:
        if not isinstance(a, torch.ScriptObject):
            continue
        try:
            group = dist.ProcessGroup.unbox(a)
        except RuntimeError:  # another boxed argument (the reduce op)
            continue
        return tuple(dist.get_process_group_ranks(group))
    return ()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.live = 0  # bytes of the storages the call made that are alive
        self.owned: set = set()  # their keys

    def _made(self, args, out) -> None:
        """Follow the storages of ``out`` that are new (not an operand's):
        add their bytes to the live count until they die."""
        known = {_storage_key(t) for t in _tensors(args)}
        for t in _tensors(out):
            key = _storage_key(t)
            if key in known or key in self.owned:
                continue
            self.owned.add(key)
            nbytes = t.untyped_storage().nbytes()
            self.live += nbytes
            self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
            weakref.finalize(t, self._died, key, nbytes)

    def _died(self, key: int, nbytes: int) -> None:
        self.owned.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                payload = float(sum(_nbytes(t) for t in _tensors(args[0])))
                c = self.cost
                c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + payload
                c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
                by_kind = c.group_bytes.setdefault(_group_ranks(args), {})
                by_kind[kind] = by_kind.get(kind, 0.0) + payload
            return out
        if func.namespace != "aten" or func.is_view:
            return out
        self._made((args, kwargs), out)
        if name in _ALLOCATIONS:
            return out
        # operands read once (an out= buffer is only written), results written
        # once: an in-place operand counts on both sides, as it is read and written
        reads = _tensors((args, {k: v for k, v in kwargs.items() if k != "out"}))
        self.cost.bytes += sum(_nbytes(t) for t in reads + _tensors(out))
        if name in _FFTS:
            self.cost.flops += _fft_flops(name, args, out)
        elif func._overloadpacket in flop_counter.flop_registry:
            self.cost.flops += float(flop_counter.flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        self.cost.launches += 1
        return out


def walk(fn, *args) -> Cost:
    """Run ``fn(*args)`` once and return what it asked of the device (see the
    module docstring).  The call runs for real: on the rank's device, with
    its collectives, so every rank of a mesh walks together (on ``meta``
    operands over a fake process group, one rank walks alone)."""
    cost = Cost()

    def hook(kernel: str, nbytes: int, flops: float) -> None:
        cost.launches += 1
        cost.bytes += nbytes
        cost.flops += flops
        cost.kernel_launches[kernel] = cost.kernel_launches.get(kernel, 0) + 1

    kernels._launch_hook = hook
    try:
        with _CostMode(cost):
            fn(*args)
    finally:
        kernels._launch_hook = None
    return cost
