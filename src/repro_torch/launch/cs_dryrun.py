"""Dry run and roofline of the paper's own workload on the production mesh.

Port of ``repro/launch/cs_dryrun.py``.  Walks one rank's CPADMM
iteration-block (50 iterations, as the recovery launcher runs it) for a
batch of large signals: each signal's transforms sharded over the model
axis, the batch over (pod x) data, the cluster-job form of the paper's
Sec. 7 deblurring.  The rank is rank 0 of a fake world of the mesh's ranks
(:func:`repro_torch.dist.compat.init_dry_run`); its blocks are ``meta``
tensors and the block is walked by :func:`repro_torch.launch.cost_walk.walk`
on the kernel tail the card runs.  The five variants:

    baseline    paper-faithful 6-transform iteration, full complex spectra
                (6 all-to-alls per iteration)
    fused       frequency-domain x-update + stacked transforms
                (2 all-to-alls per iteration)
    fused_rfft  fused + half-spectrum transforms: ~2x fewer FFT flops and
                all-to-all bytes per signal
    overlap     fused_rfft with the transposes cut into K = 4 chunks, each
                chunk's all-to-all in flight while the next chunk's first
                stage runs (same payload; the win is the hidden share)
    wire_bf16   overlap with every payload demoted to split-complex bf16
                planes by the wire_pack kernels: half the bytes on the wire

A second, multi-host section runs the best lever (fused rfft, K = 4, bf16
wires) on a ``data x host x device`` mesh (``make_hier_mesh``), data 16 x
host 2 x device 8 by default, one HGX H100 node a host, the transform axis
spanning the two hosts:

    mh_flat     one all-to-all over the factored (host, device) axis: every
                transpose byte crosses the host boundary (InfiniBand)
    mh_hier     the two-stage exchange (``hier_axes=(H, D)``): the payload
                within hosts on NVLink, the (H - 1)/H cross-host share as
                point-to-point hops (``collective-permute``) on InfiniBand

The terms come from ``roofline.model_block_times``, the plan tuner's own
model, so the tables and the tuner cannot drift apart.  Every number is a
model at H100 data-sheet rates, not a measurement.  A batch that the
(pod x) data ranks do not divide raises ``ValueError``, as the reference's
``shard_map`` does (``--multipod`` at the default batch of 16 over 32).

    PYTHONPATH=src python -m repro_torch.launch.cs_dryrun [--n1 4096 --n2 4096]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

VARIANTS = (  # (tag, fused, rfft, overlap, wire_dtype)
    ("baseline", False, False, 1, "fp32"),
    ("fused", True, False, 1, "fp32"),
    ("fused_rfft", True, True, 1, "fp32"),
    ("overlap", True, True, 4, "fp32"),
    ("wire_bf16", True, True, 4, "bf16"),
)
RHO = SIGMA = 0.01  # ExecutionPlan.cpadmm_block's defaults


def block_operands(mesh, n1, n2, batch, rfft, axis_name="model"):
    """This rank's ``meta`` blocks of one block's operands: the spectrum's
    columns, the mask's rows, and its share of ``batch`` signals over the
    (pod x) data axes -> (spectrum, mask, local batch)."""
    from ..ops.spectral import padded_rfft_len

    dp = [a for a in ("pod", "data") if a in mesh.axis_names]
    share = math.prod(mesh.size(a) for a in dp)
    if batch % share:
        raise ValueError(f"a batch of {batch} signals does not split over the {share} ranks of "
                         f"{tuple(dp)}: the batch must be a multiple of {share}")
    p = mesh.size(axis_name)
    ncols = padded_rfft_len(n2, p) if rfft else n2
    spec = torch.empty((n1, ncols // p), dtype=torch.complex64, device="meta")
    mask = torch.empty((n1 // p, n2), dtype=torch.float32, device="meta")
    return spec, mask, batch // share


def walk_variant(mesh, n1, n2, batch, iters, fused, rfft=False, overlap=1, wire_dtype="fp32",
                 axis_name="model", hier_axes=None, inter_wire_dtype="fp32"):
    """Walk one iteration block through the plan API's block
    (``ExecutionPlan.cpadmm_block``) on this rank's blocks, after one warm
    iteration (its twiddles built outside the walk, as the tuner walks)
    -> (the cost, the operands' bytes)."""
    from ..dist.recovery import DistCpadmmState
    from ..ops import spectral
    from ..ops.plan import plan_from_parts
    from .cost_walk import walk

    spec, mask, local = block_operands(mesh, n1, n2, batch, rfft, axis_name)
    pl = plan_from_parts(mesh, spec, mask, n1=n1, n2=n2, rfft=rfft, overlap=overlap,
                         fused=fused, axis_name=axis_name,
                         batch_axis="data" if "data" in mesh.axis_names else None,
                         wire_dtype=wire_dtype, hier_axes=hier_axes,
                         inter_wire_dtype=inter_wire_dtype)
    b_spec = spectral.gram_inverse_spectrum(pl.spec2d, RHO, SIGMA)
    d_diag = torch.where(pl.mask2d > 0, 1.0 / (1.0 + RHO), 1.0 / RHO).to(torch.float32)
    zeros = torch.zeros((local,) + tuple(pl.mask2d.shape), device=pl.mask2d.device)
    operands = (pl.spec2d, b_spec, d_diag, zeros, DistCpadmmState(*(zeros,) * 5))
    pl.cpadmm_block(1)(*operands)
    arg_bytes = sum(t.numel() * t.element_size() for t in operands[:4]) \
        + 5 * zeros.numel() * zeros.element_size()
    return walk(pl.cpadmm_block(iters), *operands), arg_bytes


def analyze(cost, iters, batch, overlap=1, dcn="none") -> dict:
    """The reference's keys over ``roofline.model_block_times``.  ``dcn``
    names the collective that crosses hosts: "permute" for a hierarchical
    plan (exactly its hops), "all" for a flat exchange spanning hosts,
    "none" for one host's mesh."""
    from .roofline import model_block_times

    a2a = cost.collective_bytes.get("all-to-all", 0.0)
    cp = cost.collective_bytes.get("collective-permute", 0.0)
    dcn_bytes = {"none": 0.0, "permute": float(cp), "all": float(a2a)}[dcn]
    return {
        "flops_per_dev": cost.flops,
        "bytes_per_dev": cost.bytes,
        "collective_bytes_per_dev": dict(cost.collective_bytes),
        "collective_counts": dict(cost.collective_counts),
        **model_block_times(cost, overlap, dcn_bytes=dcn_bytes),
        "per_iter_a2a": cost.collective_counts.get("all-to-all", 0) / iters,
        "flops_per_signal": cost.flops / batch,
        "a2a_bytes_per_signal": a2a / batch,
        "cp_bytes_per_signal": cp / batch,
        "kernel_launches": dict(cost.kernel_launches),
    }


def main(argv=None):
    from ..dist.compat import init_dry_run, make_hier_mesh
    from .mesh import make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n1", type=int, default=4096)
    ap.add_argument("--n2", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--hosts", type=int, default=2,
                    help="host tier extent H of the multi-host section")
    ap.add_argument("--devices-per-host", type=int, default=8,
                    help="device tier extent D of the multi-host section")
    ap.add_argument("--no-hier", action="store_true",
                    help="skip the multi-host flat-vs-hier section")
    ap.add_argument("--out", default=os.path.join("artifacts", "cs_dryrun_torch.json"))
    args = ap.parse_args(argv)

    print("modeled at H100 SXM data-sheet rates (67 TFLOP/s fp32, 3.35 TB/s, NVLink 450 GB/s, "
          "InfiniBand 50 GB/s a GPU), not measured")
    init_dry_run(512 if args.multipod else 256)
    mesh = make_production_mesh(multi_pod=args.multipod)
    results = {}
    for tag, fused, rfft, overlap, wire in VARIANTS:
        t0 = time.time()
        cost, arg_bytes = walk_variant(mesh, args.n1, args.n2, args.batch, args.iters, fused,
                                       rfft, overlap, wire)
        res = analyze(cost, args.iters, args.batch, overlap)
        res["wire_dtype"] = wire
        res["hbm_need_gb"] = (arg_bytes + cost.peak_bytes) / 1e9
        res["walk_s"] = round(time.time() - t0, 1)
        results[tag] = res
        dom = max(("compute_s", "memory_s", "effective_collective_s"), key=lambda k: res[k])
        print(
            f"{tag:10s} n={args.n1*args.n2} batch={args.batch}: "
            f"compute {res['compute_s']*1e3:.1f}ms  memory {res['memory_s']*1e3:.1f}ms  "
            f"collective {res['collective_s']*1e3:.1f}ms "
            f"(hidden {res['hidden_collective_frac']*100:.0f}% -> eff "
            f"{res['effective_collective_s']*1e3:.1f}ms)  launches {res['launches']} "
            f"({res['launch_s']*1e3:.1f}ms)  bound={dom}  "
            f"a2a/iter={res['per_iter_a2a']:.1f}  HBM {res['hbm_need_gb']:.1f}GB"
        )
    b, f, r = results["baseline"], results["fused"], results["fused_rfft"]
    o, w = results["overlap"], results["wire_bf16"]
    print(f"fused vs baseline: collective {b['collective_s']/max(f['collective_s'], 1e-12):.2f}x "
          f"down, flops {b['flops_per_dev']/max(f['flops_per_dev'], 1):.2f}x down, "
          f"bytes {b['bytes_per_dev']/max(f['bytes_per_dev'], 1):.2f}x down")
    print(f"rfft vs full-complex (fused): per-signal total flops "
          f"{f['flops_per_signal']/max(r['flops_per_signal'], 1):.2f}x down, per-signal "
          f"all-to-all bytes {f['a2a_bytes_per_signal']/max(r['a2a_bytes_per_signal'], 1):.2f}x "
          f"down")
    print(f"overlap(K={o['overlap']}) vs fused_rfft: same "
          f"{o['a2a_bytes_per_signal']/1e6:.1f}MB/signal on the wire in "
          f"{o['per_iter_a2a']:.0f} chunk-collectives/iter (was {r['per_iter_a2a']:.0f}); "
          f"hidden-collective fraction {o['hidden_collective_frac']*100:.0f}% -> effective "
          f"collective {r['collective_s']*1e3:.1f}ms -> {o['effective_collective_s']*1e3:.1f}ms "
          f"per {args.iters}-iter block")
    print(f"wire_bf16 vs overlap(fp32 wire): per-signal all-to-all bytes "
          f"{o['a2a_bytes_per_signal']/max(w['a2a_bytes_per_signal'], 1):.2f}x down; vs "
          f"fused_rfft {r['a2a_bytes_per_signal']/max(w['a2a_bytes_per_signal'], 1):.2f}x")
    print("per-signal wire/flop table:")
    for t, *_ in VARIANTS:
        row = results[t]
        print(f"  {t:10s} flops {row['flops_per_signal']/1e9:8.2f}G  "
              f"a2a {row['a2a_bytes_per_signal']/1e6:7.1f}MB  "
              f"eff-collective {row['effective_collective_s']*1e3:6.1f}ms  "
              f"wire={row['wire_dtype']}")

    if not args.no_hier:
        H, D = args.hosts, args.devices_per_host
        data = args.batch  # one data shard per signal, as in production
        init_dry_run(data * H * D)
        mesh_h = make_hier_mesh(data, H, D)
        for tag, hier, iw, dcn in (("mh_flat", None, "fp32", "all"),
                                   ("mh_hier", (H, D), "bf16", "permute")):
            t0 = time.time()
            cost, _ = walk_variant(mesh_h, args.n1, args.n2, args.batch, args.iters, fused=True,
                                   rfft=True, overlap=4, wire_dtype="bf16",
                                   axis_name=("host", "device"), hier_axes=hier,
                                   inter_wire_dtype=iw)
            res = analyze(cost, args.iters, args.batch, 4, dcn=dcn)
            res.update(wire_dtype="bf16", inter_wire_dtype=iw,
                       hier_axes=list(hier) if hier else None,
                       walk_s=round(time.time() - t0, 1))
            results[tag] = res
            print(f"{tag:10s} mesh=data{data} x host{H} x device{D}: NVLink "
                  f"{res['ici_collective_s']*1e3:.1f}ms + InfiniBand "
                  f"{res['dcn_collective_s']*1e3:.1f}ms = collective "
                  f"{res['collective_s']*1e3:.1f}ms  per-signal a2a "
                  f"{res['a2a_bytes_per_signal']/1e6:.1f}MB / inter-host "
                  f"{(res['dcn_bytes']/args.batch)/1e6:.1f}MB")
        fl, hi = results["mh_flat"], results["mh_hier"]
        print(f"hier vs flat over {H} hosts: inter-host bytes "
              f"{fl['dcn_bytes']/max(hi['dcn_bytes'], 1):.2f}x down, modeled collective "
              f"{fl['collective_s']/max(hi['collective_s'], 1e-12):.2f}x down, modeled block "
              f"{fl['modeled_total_s']/max(hi['modeled_total_s'], 1e-12):.2f}x down")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"n1": args.n1, "n2": args.n2, "batch": args.batch,
                   "mesh": "multipod" if args.multipod else "single", **results}, fh, indent=1)


if __name__ == "__main__":
    main()
