"""repro_torch.dist — the multi-rank decomposition of the recovery stack.

Port of ``repro/dist`` over ``torch.distributed`` (NCCL on the card, gloo
on the CPU and for ranks that share one card).  Module map:

    compat     ranks, meshes and process groups: ``Mesh``, ``make_mesh``,
               ``make_hier_mesh`` (data x host x device, with a joint group
               over the (host, device) transform axis),
               ``init_distributed`` (torchrun, or a world of one),
               ``spawn_fake_devices`` (gloo ranks in child processes).
    fft        the four-step n = n1 x n2 FFT on each rank's blocks:
               ``layout_2d`` / ``unlayout_2d`` / ``freq_flat`` define the
               layout; a circulant matvec costs two transpose all-to-alls
               (``make_distributed_fft``, ``make_distributed_rfft``,
               ``make_distributed_matvec``); ``overlap=K`` chunks each
               transpose, ``wire_dtype`` demotes its payload through the
               ``wire_pack`` kernels; ``hier=True`` on a (host, device)
               axis runs each transpose as the two-stage exchange (an
               intra-host all-to-all, then inter-host hops carrying 1/H of
               the flat bytes each, ``inter_wire_dtype`` on those hops).
    recovery   the CPADMM step functions (paper Alg. 3) on that layout:
               ``dist_cpadmm_step`` (six all-to-alls an iteration) and
               ``dist_cpadmm_step_fused`` (two).  No driver here:
               ``repro_torch.ops.plan.plan(op, mesh)`` lowers an operator
               onto these steps and the ``repro_torch.core.solvers``
               drivers run them.
    sharding   the LM's named-axis rules (``DEFAULT_RULES``,
               ``rules_for_arch``, ``activate_rules``) and the tensor-
               parallel collectives they put into the models over the
               mesh's ``model`` axis (``constrain``: an all-reduce of a
               row-parallel partial sum; ``grad_reduce_boundary``: an
               all-reduce of a block input's cotangent), with the data
               axis's ``fsdp_gather``.
    blocks     each LM parameter's partition spec (the reference's
               ``PARAM_RULES``), each rank's blocks of a tree
               (``shard_tree`` / ``gather_tree``) and ``ShardedLayout``,
               the checkpoints' ``plan`` of a sharded TrainState;
               ``repro_torch.launch.partition`` adds the batch, cache and
               TrainState specs.

The iteration block the tuner walks and times is
``repro_torch.ops.plan.ExecutionPlan.cpadmm_block``.  The deprecated
``recovery.make_dist_cpadmm`` shim is reachable by its full path only, not
from this package.
"""

_LAZY_MODULES = ("blocks", "compat", "fft", "recovery", "sharding")

# package-level symbols, imported on first use (importing the package loads
# neither torch.distributed's process groups nor any kernel)
_LAZY_SYMBOLS = {
    "Mesh": "compat",
    "make_mesh": "compat",
    "make_hier_mesh": "compat",
    "init_distributed": "compat",
    "spawn_fake_devices": "compat",
    "MODEL_AXIS": "compat",
    "layout_2d": "fft",
    "unlayout_2d": "fft",
    "freq_flat": "fft",
    "make_distributed_fft": "fft",
    "make_distributed_rfft": "fft",
    "make_distributed_matvec": "fft",
    "DistCpadmmParams": "recovery",
    "DistCpadmmState": "recovery",
    "dist_cpadmm_step": "recovery",
    "dist_cpadmm_step_fused": "recovery",
    "make_dist_spectrum": "recovery",
    "DEFAULT_RULES": "sharding",
    "rules_for_arch": "sharding",
    "activate_rules": "sharding",
    "current_rules": "sharding",
    "constrain": "sharding",
    "grad_reduce_boundary": "sharding",
}

__all__ = sorted(_LAZY_MODULES) + sorted(_LAZY_SYMBOLS)


def __getattr__(name: str):
    import importlib

    if name in _LAZY_MODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY_SYMBOLS:
        return getattr(importlib.import_module(f".{_LAZY_SYMBOLS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
