"""The block-time model the plan autotuner ranks candidates by, for the H100.

Port of ``model_block_times`` of ``repro/launch/roofline.py``: the same
terms and the same overlap model, priced with this card's rates, plus one
term the reference's model has no need of, the launches:

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

The reference's ``derive``, ``model_flops`` and command line read the LM
dry-run records and wait for that substrate (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

FP32_FLOPS = 67e12  # FLOP/s, float32 outside the tensor cores: NVIDIA H100 SXM data sheet
HBM_BW = 3.35e12  # B/s, HBM3: NVIDIA H100 SXM data sheet
NVLINK_BW = 450e9  # B/s a direction, NVLink 4 (900 GB/s both ways): H100 SXM data sheet
INTER_HOST_BW = 50e9  # B/s, one 400 Gb/s NDR InfiniBand port a GPU
# s, an empty kernel back to back, measured by chip_smoke.py (PERF.md section 6)
# on an NVIDIA H100 80GB HBM3 at 700 W
LAUNCH_FLOOR_S = 1.9e-6


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
    # the walk sends all-to-alls and point-to-point hops only, each byte of
    # payload once on the wire (the reference's multiplier of 1 for both)
    wire = float(sum(cost.collective_bytes.values()))
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
