"""Multi-pod dry run: walk one rank's step of every (arch x shape x mesh) cell.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell's step on 256 or 512 placeholder devices and reads the compiled
program; the port joins torch's fake process group as rank 0 of the
production mesh's 256 or 512 ranks (:func:`repro_torch.dist.compat.
init_dry_run`), cuts that rank's blocks of the cell's ``meta`` specs
(:mod:`.specs`) and walks its real train, prefill or decode step under the
arch's rules (:func:`repro_torch.launch.cost_walk.walk`), with the kernel
routes the card takes: no memory, no peers, no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron_4b \\
        --shape train_4k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8  # every cell

Each cell writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(relative to the working directory), with the reference's keys where their
meaning holds:

* ``memory``: the rank's ``argument``, ``output`` and ``alias`` bytes,
  computed from the specs before the step runs, and the walk's peak live
  bytes as ``temp`` (``None`` when the step raised);
* ``walk`` in place of ``hlo_walk``: ``flops``, ``bytes``, ``launches``,
  ``kernel_launches``, ``collective_bytes``, ``collective_counts``;
* ``collective_groups``: each group's axes, size, payload bytes and tier
  (``roofline.group_tier``: NVLink within an 8-GPU node, InfiniBand across);
* ``static_bounds``: where the step took the reference's static bound in
  place of a value a ``meta`` tensor does not have (``repro_torch.device``);
* ``rules_fallbacks``, ``params``, ``lower_s`` (the specs and the walk) and
  ``ok``; a cell whose step raises is ``ok: false`` with its ``error``.

XLA's ``cost_analysis`` and the raw HLO collectives have no counterpart
here and are not recorded.  Cells are independent; ``--all`` fans them out
over worker subprocesses, each with its own fake world.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

ARTIFACT_DIR = os.path.join("artifacts", "dryrun_torch")
MESH_RANKS = {"single": 256, "multipod": 512}


def tree_bytes(tree) -> int:
    """The bytes of every tensor leaf of nested dicts, lists and tuples."""
    from ..models.lm import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def local_args(kind: str, args: tuple, mesh, rules) -> tuple:
    """This rank's blocks of a cell's global argument specs: its blocks of
    the parameters (and moments), its rows of the batch and of the decode
    cache and its kv heads, as ``launch.partition`` lays them out."""
    from . import partition

    def batch(tree):
        return partition.shard_tree(tree, partition.batch_shardings(mesh, tree, rules), mesh)

    if kind == "train":
        state, b = args
        specs = partition.train_state_shardings(mesh, state, rules)
        return partition.shard_tree(state, specs, mesh), batch(b)
    params = partition.shard_tree(args[0], partition.param_shardings(mesh, args[0], rules), mesh)
    if kind == "prefill":
        return params, batch(args[1])
    tokens, state = args[1], args[2]
    cache = partition.shard_tree(state, partition.cache_shardings(mesh, state, rules), mesh)
    return params, batch({"tokens": tokens})["tokens"], cache


def memory(cfg, kind: str, local: tuple) -> dict:
    """The rank's argument, output and alias bytes from its blocks: a train
    step returns its state, updated in place, and a few scalars; a prefill
    its rows' last-position logits, whole over the vocabulary; a decode
    step those logits and its cache, written in place.  An encoder-decoder's
    decode step never reads the encoder's weights (its output is the
    cache's ``cross_kv``): the reference's compiled step drops an unused
    argument, and neither counts them."""
    argument = tree_bytes(local)
    if kind == "decode" and cfg.is_encdec:
        argument -= tree_bytes(local[0]["encoder"])
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    if kind == "train":
        state = tree_bytes(local[0])
        return {"argument": argument, "output": state, "alias": state, "temp": None}
    rows = local[1]["tokens"].shape[0] if kind == "prefill" else local[1].shape[0]
    logits = rows * cfg.vocab_padded * itemsize
    if kind == "prefill":
        return {"argument": argument, "output": logits, "alias": 0, "temp": None}
    cache = tree_bytes(local[2])
    return {"argument": argument, "output": logits + cache, "alias": cache, "temp": None}


def collective_groups(cost, mesh) -> list:
    """Each group the step's collectives ran over: its mesh axes, size,
    payloads by kind and tier."""
    import torch.distributed as dist

    from .roofline import group_tier

    names = {}
    for axis in mesh.axis_names:
        names[tuple(dist.get_process_group_ranks(mesh.group(axis)))] = axis
    for pair, group in mesh.pair_groups.items():
        names[tuple(dist.get_process_group_ranks(group))] = "+".join(pair)
    out = []
    for ranks, by_kind in sorted(cost.group_bytes.items()):
        out.append({"axes": names.get(ranks, "world" if len(ranks) == dist.get_world_size()
                                      else "other"),
                    "size": len(ranks), "tier": group_tier(ranks),
                    "collective_bytes": dict(by_kind)})
    return out


def walk_numbers(cost) -> dict:
    """A walk's numbers as a record keeps them."""
    return {"flops": cost.flops, "bytes": cost.bytes, "launches": cost.launches,
            "kernel_launches": dict(cost.kernel_launches),
            "collective_bytes": dict(cost.collective_bytes),
            "collective_counts": dict(cost.collective_counts)}


def walk_cell(cfg, shape: str, mesh) -> dict:
    """One rank's walk of ``cfg``'s ``shape`` cell on ``mesh`` (this
    process's rank of it): the record's numbers, ``ok`` false with the
    error when the step raises (``memory`` is recorded either way)."""
    from .specs import cell_specs

    return walk_step(cfg, *cell_specs(cfg, shape), mesh)


def walk_step(cfg, kind: str, fn, args: tuple, mesh, warm: bool = False) -> dict:
    """One rank's walk of the step ``fn`` of ``kind`` ("train", "prefill" or
    "decode") on its blocks of the global ``args`` (``meta`` specs) under
    ``cfg``'s rules on ``mesh``: :func:`walk_cell`'s record, at any shapes.
    A cell walks the step's first call (a serving step's one cast of the
    weights to the compute dtype included, as the reference's step casts
    at every call); ``warm`` walks a second call instead."""
    from .. import device as device_mod
    from ..dist.sharding import DEFAULT_RULES, activate_rules, rules_for_arch
    from ..models.config import count_params
    from .cost_walk import walk

    t0 = time.time()
    rules = rules_for_arch(cfg, mesh)
    local = local_args(kind, args, mesh, rules)
    del args  # the global specs
    rec = {
        "mesh_shape": list(mesh.axis_sizes),
        "n_devices": math.prod(mesh.axis_sizes),
        "kind": kind,
        "rules_fallbacks": {k: list(v) if isinstance(v, tuple) else v
                            for k, v in rules.items() if v != DEFAULT_RULES.get(k)},
        "memory": memory(cfg, kind, local),
        "params": count_params(cfg),
    }
    device_mod.reset_static_bounds()
    try:
        with activate_rules(rules, mesh):
            if warm:
                fn(*local)
            cost = walk(fn, *local)
    except Exception as e:  # recorded, as the reference records a failed cell
        rec.update(ok=False, error=repr(e)[:2000], lower_s=round(time.time() - t0, 1))
        return rec
    rec["memory"]["temp"] = int(cost.peak_bytes)
    rec.update(
        walk=walk_numbers(cost),
        collective_groups=collective_groups(cost, mesh),
        static_bounds=dict(device_mod.STATIC_BOUNDS),
        lower_s=round(time.time() - t0, 1),
        ok=True,
    )
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str, out_path: str) -> dict:
    """Walk ``arch``'s FULL config at ``shape`` as rank 0 of the production
    mesh ``mesh_kind`` on a fake world of its ranks; write the record to
    ``out_path`` and return it."""
    from ..configs.registry import full_config
    from ..dist.compat import init_dry_run
    from .mesh import make_production_mesh

    init_dry_run(MESH_RANKS[mesh_kind], rank=0)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    rec.update(walk_cell(full_config(arch), shape, mesh))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def all_cells():
    from ..configs.registry import all_arch_ids, cells_for

    for arch in all_arch_ids():
        for shape in cells_for(arch):
            for mesh_kind in ("single", "multipod"):
                yield arch, shape, mesh_kind


def _out(out_dir: str, arch: str, shape: str, mesh_kind: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=list(MESH_RANKS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--out-dir", default=ARTIFACT_DIR)
    ap.add_argument("--only-missing", action="store_true")
    args = ap.parse_args(argv)

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape name one cell (or pass --all)")
        rec = run_cell(args.arch, args.shape, args.mesh,
                       _out(args.out_dir, args.arch, args.shape, args.mesh))
        print(json.dumps(rec, indent=1))
        if not rec["ok"]:
            print(f"FAILED {args.arch} {args.shape} {args.mesh}: {rec['error']}",
                  file=sys.stderr)
            sys.exit(1)
        return

    # fan out over subprocesses (each joins its own fake world)
    cells = list(all_cells())
    if args.only_missing:
        cells = [c for c in cells if not os.path.exists(_out(args.out_dir, *c))]
    print(f"{len(cells)} cells to run, {args.jobs} workers", flush=True)
    procs: list = []
    done = 0
    while cells or procs:
        while cells and len(procs) < args.jobs:
            cell = cells.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0],
                   "--shape", cell[1], "--mesh", cell[2], "--out-dir", args.out_dir]
            err = tempfile.TemporaryFile(mode="w+")  # a pipe could fill and block the worker
            procs.append((subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err), err,
                          cell))
        for p, err_file, cell in list(procs):
            if p.poll() is None:
                continue
            procs.remove((p, err_file, cell))
            done += 1
            err_file.seek(0)
            err = err_file.read()
            err_file.close()
            print(f"[{done}] {cell}: {'ok' if p.returncode == 0 else 'FAIL'}", flush=True)
            if p.returncode != 0:
                print(err[-1500:], flush=True)
        time.sleep(0.5)
    print("dry-run sweep complete")


if __name__ == "__main__":
    main()
