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
launch and its operand and result bytes through
:func:`repro_torch.kernels.report_launch`, which only a running walk hears.

Collective operations (the ``c10d`` namespace) add nothing here: their
payload is wire bytes, read from :data:`repro_torch.dist.fft.WIRE_BYTES`
before and after the call, under the reference's names so that a cost
prices the same way in both packages: the flat and intra-host tiers as
``"all-to-all"``, the inter-host hops as ``"collective-permute"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import kernels
from ..dist import fft as dist_fft

# allocations: a new buffer, nothing read or written on the device
_ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                          "new_empty_strided"})
_FFTS = {"_fft_c2c": 1.0, "_fft_r2c": 0.5, "_fft_c2r": 0.5}  # flops factor per 5 N log2 N
_WIRE_NAMES = {"flat": "all-to-all", "intra": "all-to-all", "inter": "collective-permute"}


@dataclasses.dataclass
class Cost:
    """What one call asked of the device (see module docstring)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches: int = 0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

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


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace != "aten" or func.is_view or name in _ALLOCATIONS:
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
    its collectives, so every rank of a mesh walks together."""
    cost = Cost()

    def hook(kernel: str, nbytes: int) -> None:
        cost.launches += 1
        cost.bytes += nbytes
        cost.kernel_launches[kernel] = cost.kernel_launches.get(kernel, 0) + 1

    wire0 = dict(dist_fft.WIRE_BYTES)
    kernels._launch_hook = hook
    try:
        with _CostMode(cost):
            fn(*args)
    finally:
        kernels._launch_hook = None
    for tier, name in _WIRE_NAMES.items():
        sent = dist_fft.WIRE_BYTES[tier] - wire0[tier]
        if sent:
            cost.collective_bytes[name] = cost.collective_bytes.get(name, 0.0) + float(sent)
    return cost
