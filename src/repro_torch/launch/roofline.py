"""The roofline of the dry runs and the block-time model of the plan
autotuner, for the H100.

Port of ``repro/launch/roofline.py``.  :func:`model_block_times` has the
reference's terms and overlap model, priced with this card's rates, plus
one term the reference's model has no need of, the launches:

    compute term     = flops / FP32_FLOPS
    memory term      = bytes / HBM_BW
    collective term  = intra-host wire bytes / NVLINK_BW
                       + inter-host wire bytes / INTER_HOST_BW
    launch term      = launches x LAUNCH_FLOOR_S

A kernel launch costs the stream its floor whatever it moves (an empty
kernel back to back takes 1.9 us on the H100), so a step of many small
operations is dearer than its bytes say: without the term a plain step and
a kernel step that move the same bytes in 23 and 18 launches would rank
level.  The cost comes from :func:`repro_torch.launch.cost_walk.walk`.
Wire bytes take the reference's multipliers (:data:`WIRE_MULT`): an
all-reduce moves about twice its payload, every other collective once.

:func:`derive` prices one LM dry-run record (:mod:`repro_torch.launch.
dryrun`) the reference's way, at bf16 tensor-core rates:

    compute term     = flops / BF16_FLOPS
    memory term      = bytes / HBM_BW
    collective term  = for each collective group of the step, its wire bytes
                       over NVLINK_BW when its ranks share one 8-GPU node,
                       over INTER_HOST_BW when they span nodes

A production mesh runs on HGX H100 nodes of :data:`GPUS_PER_NODE` cards,
rank r on node r // 8.  Its memory column is ``fits_hbm``, the rank's
argument, peak and output bytes less what aliases an argument against
:data:`HBM_BYTES`, an H100's 80 GB (the reference's ``fits_16g`` is a TPU
v5e's 16 GB).  Every number it gives is a model at data-sheet rates, not a
measurement.

    python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch] [--mesh all]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

from ..configs.registry import SHAPES

FP32_FLOPS = 67e12  # FLOP/s, float32 outside the tensor cores: NVIDIA H100 SXM data sheet
BF16_FLOPS = 989e12  # FLOP/s, dense bf16 on the tensor cores: NVIDIA H100 SXM data sheet
HBM_BW = 3.35e12  # B/s, HBM3: NVIDIA H100 SXM data sheet
NVLINK_BW = 450e9  # B/s a direction, NVLink 4 (900 GB/s both ways): H100 SXM data sheet
INTER_HOST_BW = 50e9  # B/s, one 400 Gb/s NDR InfiniBand port a GPU
# s, an empty kernel back to back, measured by chip_smoke.py (PERF.md section 6)
# on an NVIDIA H100 80GB HBM3 at 700 W
LAUNCH_FLOOR_S = 1.9e-6
HBM_BYTES = 80e9  # an H100 80GB's device memory
GPUS_PER_NODE = 8  # an HGX H100 node: NVLink within it, InfiniBand between nodes

WIRE_MULT = {
    "all-reduce": 2.0,  # ring: reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def wire_bytes(collective_bytes: dict) -> float:
    """The bytes that cross the wire for payloads ``{collective: bytes}``."""
    return float(sum(WIRE_MULT.get(op, 1.0) * b for op, b in collective_bytes.items()))


def model_block_times(cost, overlap: int = 1, dcn_bytes: float = 0.0, *,
                      peak_flops: float = FP32_FLOPS, hbm_bw: float = HBM_BW,
                      link_bw: float = NVLINK_BW, inter_host_bw: float = INTER_HOST_BW,
                      launch_floor_s: float = LAUNCH_FLOOR_S) -> dict:
    """Roofline terms, the hidden-collective overlap model and the launch
    term for one walked block (a :class:`~repro_torch.launch.cost_walk.Cost`).

    ``dcn_bytes`` is the part of the wire bytes that crosses a host boundary
    and rides ``inter_host_bw`` instead of ``link_bw`` (clamped to the
    total).  The keys keep the reference's names: ``ici_collective_s`` is
    the intra-host tier (NVLink here), ``dcn_collective_s`` and
    ``dcn_bytes`` the inter-host tier.  The rates are keyword arguments so
    that one cost can be priced at other constants.

    Overlap model (the reference's): with the transpose cut into K chunks,
    chunk i's collective flies while chunk i+1's first FFT stage runs, so at
    most (K-1)/K of the wire time hides, and never more than half the local
    time (the first stage's share).  The launches do not hide: the stream
    pays each one's floor in turn.
    """
    wire = wire_bytes(cost.collective_bytes)
    compute_s = cost.flops / peak_flops
    memory_s = cost.bytes / hbm_bw
    dcn_wire = min(float(dcn_bytes), wire)
    ici_s = (wire - dcn_wire) / link_bw
    dcn_s = dcn_wire / inter_host_bw
    collective_s = ici_s + dcn_s
    local_s = max(compute_s, memory_s)
    hidden_s = min((overlap - 1) / overlap * collective_s, 0.5 * local_s)
    effective_s = collective_s - hidden_s
    launch_s = cost.launches * launch_floor_s
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "ici_collective_s": ici_s,
        "dcn_collective_s": dcn_s,
        "dcn_bytes": dcn_wire,
        "overlap": overlap,
        "hidden_collective_s": hidden_s,
        "hidden_collective_frac": hidden_s / collective_s if collective_s else 0.0,
        "effective_collective_s": effective_s,
        "launches": cost.launches,
        "launch_s": launch_s,
        "modeled_total_s": local_s + effective_s + launch_s,
    }


def group_tier(ranks) -> str:
    """``"nvlink"`` when the ``ranks`` of a group share one node of
    :data:`GPUS_PER_NODE` cards, ``"inter_host"`` when they span nodes."""
    return "nvlink" if len({r // GPUS_PER_NODE for r in ranks}) == 1 else "inter_host"


def model_flops(rec: dict) -> float:
    """6 N D of a train step, 2 N D of a prefill, 2 N B of a decode step (N
    the active parameters, D the tokens): the reference's useful work."""
    seq, batch, kind = SHAPES[rec["shape"]]
    n_active = rec["params"]["active"]
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch  # decode: one token per sequence


def derive(rec: dict) -> dict:
    """The roofline row of one ``ok`` dry-run record (see the module
    docstring): the three terms, the bottleneck, the bound, the useful
    ratio 6ND / (walked flops x ranks), the rank's HBM need and whether it
    fits an H100."""
    w = rec["walk"]
    n_dev = rec["n_devices"]
    compute_s = w["flops"] / BF16_FLOPS
    memory_s = w["bytes"] / HBM_BW
    by_tier = {"nvlink": 0.0, "inter_host": 0.0}
    for g in rec["collective_groups"]:
        by_tier[g["tier"]] += wire_bytes(g["collective_bytes"])
    collective_s = by_tier["nvlink"] / NVLINK_BW + by_tier["inter_host"] / INTER_HOST_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(rec)
    walked_global = w["flops"] * n_dev
    mem = rec["memory"]
    hbm_need = mem["argument"] + mem["temp"] + mem["output"] - mem["alias"]
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "kind", "n_devices")},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "nvlink_wire_bytes": by_tier["nvlink"],
        "inter_host_wire_bytes": by_tier["inter_host"],
        "bottleneck": bottleneck,
        "step_s_bound": max(terms.values()),
        "roofline_fraction": compute_s / max(terms.values()) if max(terms.values()) else 0.0,
        "model_flops": mf,
        "walked_flops_global": walked_global,
        "useful_ratio": mf / walked_global if walked_global else 0.0,
        "hbm_need_bytes": hbm_need,
        "fits_hbm": hbm_need <= HBM_BYTES,
        "collective_detail": w["collective_bytes"],
    }


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default="single", help="single|multipod|all")
    ap.add_argument("--json-out", default="artifacts/roofline_torch.json")
    args = ap.parse_args(argv)

    rows: List[dict] = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if args.mesh != "all" and rec.get("mesh") != args.mesh:
            continue
        if not rec.get("ok"):
            rows.append({k: rec.get(k) for k in ("arch", "shape", "mesh")}
                        | {"error": rec.get("error", ""), "memory": rec.get("memory")})
            continue
        rows.append(derive(rec))

    rows.sort(key=lambda r: (r.get("arch") or "", r.get("shape") or "", r.get("mesh") or ""))
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)

    print("modeled at H100 SXM data-sheet rates (989 TFLOP/s bf16, 3.35 TB/s, NVLink "
          "450 GB/s, InfiniBand 50 GB/s a GPU), not measured")
    print("| arch | shape | mesh | compute | memory | collective | bound | roofline frac "
          "| useful (6ND/walk) | HBM need/rank | fits 80G |")
    print("|" + "---|" * 11)
    for r in rows:
        if r.get("error") is not None:
            mem = r.get("memory") or {}
            need = mem.get("argument", 0) + mem.get("output", 0) - mem.get("alias", 0)
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | | | | | | "
                  f"{need/1e9:.1f}GB (no temp) | |")
            continue
        print(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"**{r['bottleneck']}** | {r['roofline_fraction']*100:.0f}% | "
            f"{min(r['useful_ratio'], 99):.2f} | {r['hbm_need_bytes']/1e9:.1f}GB | "
            f"{'Y' if r['fits_hbm'] else 'N'} |"
        )


if __name__ == "__main__":
    main()
