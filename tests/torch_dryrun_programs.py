"""Programs the dry-run tests run in subprocesses, one per call.

    python tests/torch_dryrun_programs.py <program> '<json keyword arguments>'

prints the program's result as one JSON line, last.  The ``port_*``
programs import torch and ``repro_torch`` alone and join a process group
(the fake one of :func:`repro_torch.dist.compat.init_dry_run`, or a gloo
world of one), which never happens in the pytest process.  The ``ref_*``
programs run the reference on 8 XLA placeholder devices, through its own
``repro.dist.compat`` meshes; the device count is set before JAX loads.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

CS_VARIANTS = ("baseline", "fused", "fused_rfft", "overlap", "wire_bf16")
MH_FORMS = (("mh_flat", None, "fp32"), ("mh_hier", (2, 2), "bf16"))


class Started:
    """A program running in a fresh interpreter; :meth:`result` waits for
    its JSON result (and raises with its error output if it failed)."""

    def __init__(self, program: str, kwargs: dict):
        self.program = program
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), program,
                                      json.dumps(kwargs)], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self._result = None

    def result(self, timeout: float = 600):
        if self._result is None:
            out, err = self.proc.communicate(timeout=timeout)
            if self.proc.returncode != 0:
                raise RuntimeError(f"{self.program} failed ({self.proc.returncode}):\n"
                                   f"{err[-4000:]}")
            self._result = json.loads(out.strip().splitlines()[-1])
        return self._result


def start(program: str, **kwargs) -> Started:
    return Started(program, kwargs)


def run(program: str, **kwargs):
    """Run ``program`` in a fresh interpreter -> its JSON result."""
    return start(program, **kwargs).result()


def _cost_dict(flops, nbytes, coll, counts):
    return {"flops": float(flops), "bytes": float(nbytes),
            "collective_bytes": {k: float(v) for k, v in coll.items()},
            "collective_counts": {k: float(v) for k, v in counts.items()}}


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def port_cs(n1, n2, batch, iters):
    """The CS dry run's five variants on a (2, 4) mesh and its two
    multi-host forms on data 2 x host 2 x device 2, rank 0 of a fake world
    of 8; then the multi-pod mesh's default batch of 16 over 32."""
    from repro_torch.dist.compat import init_dry_run, make_hier_mesh, make_mesh
    from repro_torch.launch import cs_dryrun
    from repro_torch.launch.mesh import make_production_mesh

    init_dry_run(8)
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for tag, fused, rfft, overlap, wire in cs_dryrun.VARIANTS:
        cost, _ = cs_dryrun.walk_variant(mesh, n1, n2, batch, iters, fused, rfft, overlap, wire)
        out[tag] = dict(_cost_dict(cost.flops, cost.bytes, cost.collective_bytes,
                                   cost.collective_counts),
                        kernel_launches=cost.kernel_launches, launches=cost.launches)
    mesh_h = make_hier_mesh(2, 2, 2)
    for tag, hier, iw in MH_FORMS:
        cost, _ = cs_dryrun.walk_variant(mesh_h, n1, n2, batch, iters, True, True, 4, "bf16",
                                         axis_name=("host", "device"), hier_axes=hier,
                                         inter_wire_dtype=iw)
        out[tag] = _cost_dict(cost.flops, cost.bytes, cost.collective_bytes,
                              cost.collective_counts)
    init_dry_run(512)
    try:
        cs_dryrun.walk_variant(make_production_mesh(multi_pod=True), n1, n2, 16, iters, True)
        out["multipod_16"] = "ran"
    except ValueError as e:
        out["multipod_16"] = f"ValueError: {e}"
    return out


def _block(mesh, n1, n2, batch, tail, wire):
    """A kernel-or-plain tail CS block's plan and operands on ``mesh``'s
    device, its values irrelevant (zeros)."""
    import torch

    from repro_torch.dist.recovery import DistCpadmmState
    from repro_torch.ops import spectral
    from repro_torch.ops.plan import plan_from_parts

    dev = mesh.device
    p = mesh.size("model")
    spec = torch.zeros((n1, (n2 // 2 + 1 + p - 1) // p * p // p), dtype=torch.complex64,
                       device=dev)
    mask = torch.zeros((n1 // p, n2), device=dev)
    pl = plan_from_parts(mesh, spec, mask, n1=n1, n2=n2, rfft=True, overlap=2, tail=tail,
                         wire_dtype=wire)
    zeros = torch.zeros((batch,) + tuple(mask.shape), device=dev)
    b_spec = spectral.gram_inverse_spectrum(pl.spec2d, 0.01, 0.01)
    d_diag = torch.where(pl.mask2d > 0, 1.0 / 1.01, 100.0).to(torch.float32)
    return pl, (pl.spec2d, b_spec, d_diag, zeros, DistCpadmmState(*(zeros,) * 5))


def _walk_both_ways(pl, operands, iters):
    from repro_torch.dist import fft as dist_fft
    from repro_torch.launch.cost_walk import walk

    pl.cpadmm_block(1)(*operands)
    wire0 = dict(dist_fft.WIRE_BYTES)
    cost = walk(pl.cpadmm_block(iters), *operands)
    wire = {t: dist_fft.WIRE_BYTES[t] - wire0[t] for t in wire0}
    return dict(_cost_dict(cost.flops, cost.bytes, cost.collective_bytes,
                           cost.collective_counts),
                launches=cost.launches, kernel_launches=cost.kernel_launches, wire=wire)


def port_walks(n1, n2, batch, iters):
    """One CS block on a gloo world of one on the CPU (the plain tail, fp32
    and bf16 wires), then the same blocks on ``meta`` over a fake world of
    one; each walk with the wire bytes ``dist.fft.WIRE_BYTES`` counted
    around it."""
    from repro_torch.dist.compat import init_dry_run, make_mesh

    out = {}
    mesh = make_mesh((1,), ("model",), device="cpu")
    for wire in ("fp32", "bf16"):
        out["cpu", wire] = _walk_both_ways(*_block(mesh, n1, n2, batch, "plain", wire), iters)
    init_dry_run(1)
    mesh = make_mesh((1,), ("model",))
    for wire in ("fp32", "bf16"):
        out["meta", wire] = _walk_both_ways(*_block(mesh, n1, n2, batch, "plain", wire), iters)
        out["meta-kernel", wire] = _walk_both_ways(*_block(mesh, n1, n2, batch, "kernel", wire),
                                                   iters)
    return {"/".join(k): v for k, v in out.items()}


def port_collectives():
    """One all-reduce, one all-gather and one all-to-all over a group of 4
    of a fake world of 8, each walked alone."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.compat import init_dry_run, make_mesh
    from repro_torch.launch.cost_walk import walk

    init_dry_run(8)
    mesh = make_mesh((2, 4), ("data", "model"))
    g = mesh.group("model")
    x = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    out = {}
    for name, fn in (
            ("all-reduce", lambda: dist.all_reduce(x, group=g)),
            ("all-gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(4)], x,
                                                   group=g)),
            ("all-to-all", lambda: dist.all_to_all_single(torch.empty_like(x), x, group=g))):
        cost = walk(fn)
        out[name] = dict(_cost_dict(cost.flops, cost.bytes, cost.collective_bytes,
                                    cost.collective_counts), launches=cost.launches,
                         groups=[list(k) for k in cost.group_bytes])
    return out


def port_cells(arch_shapes, smoke=True, mesh_shape=(2, 4), out_dir=None):
    """``dryrun.walk_cell`` of each (arch, shape) on rank 0 of a fake world
    (SMOKE configs on ``mesh_shape``, or FULL on the production mesh);
    each record written under ``out_dir`` as ``run_cell`` writes it."""
    from repro_torch.configs.registry import full_config, smoke_config
    from repro_torch.dist.compat import init_dry_run, make_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    out = {}
    for arch, shape, mesh_kind in arch_shapes:
        if smoke:
            init_dry_run(mesh_shape[0] * mesh_shape[1])
            mesh = make_mesh(mesh_shape, ("data", "model"))
        else:
            init_dry_run(dryrun.MESH_RANKS[mesh_kind])
            mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
        cfg = (smoke_config if smoke else full_config)(arch)
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
        rec.update(dryrun.walk_cell(cfg, shape, mesh))
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json"), "w") as f:
                json.dump(rec, f)
        out[f"{arch}/{shape}/{mesh_kind}"] = rec
    return out


# ---------------------------------------------------------------------------
# the reference, on 8 placeholder devices
# ---------------------------------------------------------------------------


def ref_cs(n1, n2, batch, iters):
    from repro.dist.compat import make_hier_mesh, make_mesh
    from repro.launch import cs_dryrun
    from repro.launch.hlo_analysis import analyze_compiled

    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for tag, fused, rfft, overlap, wire in cs_dryrun.VARIANTS:
        c = analyze_compiled(cs_dryrun.lower_variant(mesh, n1, n2, batch, iters, fused, rfft,
                                                     overlap, wire))
        out[tag] = _cost_dict(c.flops, c.bytes, c.collective_bytes, c.collective_counts)
    mesh_h = make_hier_mesh(2, 2, 2)
    for tag, hier, iw in MH_FORMS:
        c = analyze_compiled(cs_dryrun.lower_variant(
            mesh_h, n1, n2, batch, iters, fused=True, rfft=True, overlap=4, wire_dtype="bf16",
            axis_name=("host", "device"), hier_axes=hier, inter_wire_dtype=iw))
        out[tag] = _cost_dict(c.flops, c.bytes, c.collective_bytes, c.collective_counts)
    return out


def ref_argument_bytes(cells):
    """``memory_analysis().argument_size_in_bytes`` of each (arch, shape)
    SMOKE cell compiled on a (2, 4) mesh, as ``repro.launch.dryrun.run_cell``
    compiles a production cell."""
    import jax

    from repro.configs.registry import smoke_config
    from repro.dist.compat import make_mesh
    from repro.dist.sharding import activate_rules, rules_for_arch
    from repro.launch import partition
    from repro.launch.specs import cell_specs

    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch, shape in cells:
        cfg = smoke_config(arch)
        rules = rules_for_arch(cfg, mesh)
        kind, fn, args = cell_specs(cfg, shape)
        if kind == "train":
            in_sh = (partition.train_state_shardings(mesh, args[0], rules),
                     partition.batch_shardings(mesh, args[1], rules))
        elif kind == "prefill":
            in_sh = (partition.param_shardings(mesh, args[0], rules),
                     partition.batch_shardings(mesh, args[1], rules))
        else:
            in_sh = (partition.param_shardings(mesh, args[0], rules),
                     partition.batch_shardings(mesh, args[1], rules),
                     partition.cache_shardings(mesh, args[2], rules))
        with activate_rules(rules, mesh):
            compiled = jax.jit(fn, in_shardings=in_sh).lower(*args).compile()
        out[f"{arch}/{shape}"] = int(compiled.memory_analysis().argument_size_in_bytes)
    return out


def main():
    name, kwargs = sys.argv[1], json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
    if name.startswith("ref_"):
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.abspath(SRC))
    result = globals()[name](**kwargs)
    print(json.dumps(result, default=list))


if __name__ == "__main__":
    main()
