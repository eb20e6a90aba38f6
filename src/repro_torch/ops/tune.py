"""Plan autotuning: pick a :class:`PlanConfig` instead of hand-picking one.

Port of ``repro/ops/tune.py``.  The paper's speedup came from matching the
algorithm's layout to the GPU's limits by hand; on the plan layer the same
matching reappears as knobs (rfft, overlap K, the tail, the batch split,
the four-step ``n1 x n2``, the wire precision, the flat or hierarchical
exchange), and this module picks them:

    ``plan(op, mesh, tune=True)``            the cost model's pick ("model")
    ``plan(op, mesh, tune="measure")``       + the top candidates timed

Pipeline
--------
1.  **Enumerate** (:func:`candidate_configs`): feasible factorizations,
    rfft on and off, K in {1, 2, 4, 8}, the tails this device runs
    (``plain`` and ``kernel`` on CUDA, ``plain`` elsewhere), the batch
    splits the workload's batch divides over, fp32 and bf16 wires, and on a
    ``(host, device)`` mesh the flat against the hierarchical exchange with
    each inter-host wire.  A pin (a knob the caller passed) collapses its
    axis of the space.
2.  **Score** (:func:`score_candidates`): run one concrete iteration block
    per overlap group (:meth:`ExecutionPlan.cpadmm_block` on the plan's
    spectrum and a zero state) under :func:`repro_torch.launch.cost_walk.
    walk`, and rank by :func:`repro_torch.launch.roofline.model_block_times`.
    Candidates that differ only in K share one walk: K changes how the
    transposes are scheduled, not what they carry, so the K sweep is
    analytic on the K = 1 walk.  The reference lowers an abstract block to
    HLO instead; the port has no compiled program to read, so its blocks
    run for real, on every rank (the blocks hold collectives).
3.  **Measure** (``mode="measure"``): time the best candidate of each of
    the ``top_k`` best walked groups on the device (CUDA events on the card,
    the host clock on the CPU; on a mesh the slowest rank's time, so every
    rank ranks alike) and let the measured time decide.
4.  **Cache**: the winner lands in a JSON store (:class:`PlanCache`,
    default ``artifacts/plan_cache_torch.json``, ``REPRO_TORCH_PLAN_CACHE``
    overrides it; never the reference's file) keyed by the operator's
    signature, the mesh, the batch, the dtype, the torch version, the
    device's name and the pins.  A "measure" entry serves both modes; a
    "model" entry is tuned again when measurement is asked for.  On a mesh,
    rank 0 alone reads and writes the store and broadcasts the hit or the
    winner, so the ranks can never disagree (a disagreement would deadlock
    the next collective).

A candidate that fails to build or to launch raises: none is skipped, and
a kernel tail never quietly becomes the plain one.

``COUNTERS`` counts walks (``scored``), timed candidates (``measured``)
and the store's hits and misses, so a test can assert that a warm store
skips all scoring.

    python -m repro_torch.ops.tune --show     # inspect the store
    python -m repro_torch.ops.tune --clear    # drop it (after a torch upgrade)
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import models_the_card
from ..dist.compat import DEVICE_AXIS, HOST_AXIS, MODEL_AXIS
from . import spectral
from .plan import PlanConfig, _factorize, _plan_with_config

DEFAULT_CACHE_PATH = os.path.join("artifacts", "plan_cache_torch.json")
OVERLAPS = (1, 2, 4, 8)
SCORE_ITERS = 8  # iterations in a scored block: enough to dwarf one-off setup
RANKING = 5  # candidates of the model's ranking kept in a store entry
MEASURE_REPEATS = 3

# scored: groups walked; measured: candidates timed; cache_hits/misses:
# PlanCache lookups.  A warm store leaves scored == measured == 0.
COUNTERS: Dict[str, int] = {
    "scored": 0, "measured": 0, "cache_hits": 0, "cache_misses": 0,
}


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


# stores already warned about in this process: a corrupt store is
# quarantined with one warning, not one per lookup
_WARNED_CORRUPT: set = set()


class PlanCache:
    """JSON store of winning configs: ``key -> {config, mode, score, ...}``.

    Writes are atomic (a temporary file, then a rename), and :meth:`put`
    reads the store again just before the rename and folds in any entry
    another tuner wrote meanwhile, so two tuners racing on different keys
    both land (on one key the last writer wins: both wrote a winner for the
    same workload).  A store that does not parse is never taken for an empty
    one: it is moved to ``<path>.corrupt`` with a one-time warning.  The
    default path is overridden by ``REPRO_TORCH_PLAN_CACHE``.
    """

    # test seam: called between the temporary write and the re-read before
    # the rename, where a concurrent tuner's rename can land
    _race_hook = None

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("REPRO_TORCH_PLAN_CACHE", DEFAULT_CACHE_PATH)

    def _quarantine(self, reason: str) -> None:
        corrupt = f"{self.path}.corrupt"
        try:
            os.replace(self.path, corrupt)
        except OSError:
            corrupt = "<unmovable>"
        if self.path not in _WARNED_CORRUPT:
            _WARNED_CORRUPT.add(self.path)
            warnings.warn(
                f"plan cache {self.path} is unreadable ({reason}); quarantined to {corrupt} "
                f"and starting a fresh store: delete the .corrupt file once inspected",
                RuntimeWarning,
                stacklevel=3,
            )

    def _load(self) -> Dict[str, dict]:
        try:
            with open(self.path) as f:
                raw = f.read()
        except OSError:  # no store yet: empty
            return {}
        if not raw.strip():
            return {}
        try:
            data = json.loads(raw)
        except ValueError as e:
            self._quarantine(f"invalid JSON: {e}")
            return {}
        if not isinstance(data, dict):
            self._quarantine(f"top-level JSON is {type(data).__name__}, not dict")
            return {}
        return data

    def get(self, key: str) -> Optional[dict]:
        return self._load().get(key)

    def put(self, key: str, entry: dict) -> None:
        data = self._load()
        data[key] = entry
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # a temporary file per call: two racing puts in one process never share one
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(self.path) + ".tmp.", dir=d or ".")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        if self._race_hook is not None:
            self._race_hook()
        # another tuner may have replaced the store since the load above:
        # merge its entries in (this key keeps ours) before the rename
        latest = self._load()
        if any(k not in data for k in latest):
            latest.update(data)
            with open(tmp, "w") as f:
                json.dump(latest, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def clear(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass

    def entries(self) -> Dict[str, dict]:
        return self._load()


def _device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def cache_key(op, mesh, batch: Optional[int], pins: Optional[dict]) -> str:
    """Everything the winning config depends on, as one string.

    The operator's signature (type, n, m), not its identity: two operators
    of one size tune alike, as the knobs depend on shapes, not values.  The
    torch version and the device's name stand where the reference has its
    jax version and backend: the cost of a step is a property of both.
    """
    sig = (type(op).__name__, getattr(op, "n", None), getattr(op, "m", None))
    axes = tuple((a, mesh.size(a)) for a in mesh.axis_names)
    dtype = str(getattr(op, "circ", op).col.dtype)

    def _jsonable(v):
        if hasattr(v, "to_dict") and hasattr(v, "tag"):  # a prox pin
            return v.to_dict()
        return list(v) if isinstance(v, tuple) else v

    pin_s = json.dumps({k: _jsonable(v) for k, v in sorted((pins or {}).items())})
    return "|".join([
        f"op={sig}", f"mesh={axes}", f"batch={batch}", f"dtype={dtype}",
        f"torch={torch.__version__}", f"device={_device_name(mesh.device)}",
        f"pins={pin_s}",
    ])


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------


def _feasible_factorizations(n: int, p: int, rfft: bool,
                             extra: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The near-sqrt default of ``_factorize`` and the caller's extras,
    without repeats, each split evenly over the transform axis."""
    out: List[Tuple[int, int]] = []
    try:
        out.append(_factorize(n, None, None, p, rfft))
    except ValueError:
        pass
    for n1, n2 in extra:
        if n1 * n2 != n or n1 % p:
            continue
        if not rfft and n2 % p:
            continue
        if (n1, n2) not in out:
            out.append((n1, n2))
    return out


def candidate_configs(op, mesh, pins: Optional[dict] = None, batch: Optional[int] = None,
                      extra_factorizations: Sequence[Tuple[int, int]] = ()) -> List[PlanConfig]:
    """The feasible candidate space, in the reference's order, honouring ``pins``.

    A pin collapses its knob's axis to the pinned value; ``n1`` / ``n2``
    pins replace the factorization sweep.
    """
    pins = dict(pins or {})
    axis_name = pins.get("axis_name")
    if axis_name is None:
        # a hierarchical mesh implies the factored transform axis, over which
        # the flat and the two-stage exchange race (the hier sweep below)
        if HOST_AXIS in mesh.axis_names and DEVICE_AXIS in mesh.axis_names:
            axis_name = (HOST_AXIS, DEVICE_AXIS)
        else:
            axis_name = MODEL_AXIS
    if isinstance(axis_name, (list, tuple)):
        axis_name = tuple(axis_name)
    t_axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    missing = [a for a in t_axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axis_name {axis_name!r} not in mesh axes {mesh.axis_names}")
    p = math.prod(mesh.size(a) for a in t_axes)
    n = getattr(op, "circ", op).n

    rffts = (pins["rfft"],) if "rfft" in pins else (False, True)
    overlaps = (pins["overlap"],) if "overlap" in pins else OVERLAPS
    if "tail" in pins:
        tails: Tuple[str, ...] = (pins["tail"],)
    elif models_the_card(mesh.device):  # the card, or meta standing for it
        tails = ("plain", "kernel")
    else:
        tails = ("plain",)  # off the card the kernel tail is the plain version
    fuseds = (pins["fused"],) if "fused" in pins else (True,)
    # the free sweep stops at bf16 (fp32's exponent range, so the plan's
    # precision guard all but always accepts it); fp16 is a pin only
    wires = (pins["wire_dtype"],) if "wire_dtype" in pins else ("fp32", "bf16")

    if isinstance(axis_name, tuple):
        extents = tuple(mesh.size(a) for a in axis_name)
        if "hier_axes" in pins:
            ha = pins["hier_axes"]
            hier_opts: Tuple[Any, ...] = (tuple(ha) if ha is not None else None,)
        else:
            hier_opts = (None, extents)
    else:
        ha = pins.get("hier_axes")
        hier_opts = (tuple(ha) if ha is not None else None,)
    # a demoted inter wire exists only on the hierarchical exchange
    if pins.get("inter_wire_dtype", "fp32") != "fp32":
        hier_opts = tuple(h for h in hier_opts if h is not None)
        if not hier_opts:
            raise ValueError(
                "inter_wire_dtype pin needs a hierarchical candidate space "
                "(a (host, device) mesh, or hier_axes pinned non-None)"
            )

    def _inter_wires(hier) -> Tuple[str, ...]:
        if hier is None:
            return ("fp32",)
        if "inter_wire_dtype" in pins:
            return (pins["inter_wire_dtype"],)
        return ("fp32", "bf16")

    if "batch_axis" in pins:
        batch_axes: List[Any] = [pins["batch_axis"]]
    else:
        batch_axes = [None]
        other = tuple(a for a in mesh.axis_names if a not in t_axes)
        if other and batch:
            sizes = math.prod(mesh.size(a) for a in other)
            if sizes > 1 and batch % sizes == 0:
                batch_axes.append(other if len(other) > 1 else other[0])

    out: List[PlanConfig] = []
    for rfft in rffts:
        if "n1" in pins or "n2" in pins:
            try:
                facs = [_factorize(n, pins.get("n1"), pins.get("n2"), p, rfft)]
            except ValueError:
                continue
        else:
            facs = _feasible_factorizations(n, p, rfft, extra_factorizations)
        for n1, n2 in facs:
            for tail in tails:
                for fused in fuseds:
                    for ba in batch_axes:
                        for wire in wires:
                            for hier in hier_opts:
                                for iw in _inter_wires(hier):
                                    for K in overlaps:
                                        out.append(PlanConfig(
                                            rfft=rfft, overlap=K, tail=tail, fused=fused,
                                            batch_axis=ba, n1=n1, n2=n2,
                                            axis_name=axis_name, wire_dtype=wire,
                                            hier_axes=hier, inter_wire_dtype=iw,
                                            prox=pins.get("prox"),
                                        ))
    if not out:
        raise ValueError(
            f"no feasible plan candidates for n={n} over a {p}-device {axis_name!r} axis "
            f"with pins {pins}"
        )
    return out


# ---------------------------------------------------------------------------
# scoring (a walked block + the shared cost model)
# ---------------------------------------------------------------------------


def _group_key(cfg: PlanConfig) -> tuple:
    """Candidates equal up to overlap share one walk (see module docstring).

    The wire dtype is in the key (a demoted wire changes the bytes each
    exchange carries and adds the pack and unpack kernels), and so are the
    hierarchical knobs (other collectives entirely) and the prior (a
    whole-signal prior takes the hybrid step)."""
    return (cfg.rfft, cfg.n1, cfg.n2, cfg.tail, cfg.fused, cfg.batch_axis, cfg.axis_name,
            cfg.wire_dtype, cfg.hier_axes, cfg.inter_wire_dtype, cfg.prox)


def _block_operands(pl, batch: int) -> tuple:
    """A block's concrete operands on this rank: the plan's spectrum, the
    inverse's spectrum and diagonal at ``cpadmm_block``'s defaults, and a
    zero P^T y and state of this rank's share of ``batch`` signals (the cost
    of an iteration does not depend on the values)."""
    from ..dist.recovery import DistCpadmmState

    rho = sigma = 0.01  # cpadmm_block's defaults
    b_spec = spectral.gram_inverse_spectrum(pl.spec2d, rho, sigma)
    d_diag = torch.where(pl.mask2d > 0, 1.0 / (1.0 + rho), 1.0 / rho).to(torch.float32)
    share = pl.mesh.size(pl.batch_axis) if pl.batch_axis is not None else 1
    if batch % share:
        raise ValueError(f"a batch of {batch} signals does not split over the {share}-way "
                         f"{pl.batch_axis!r} axis")
    zeros = torch.zeros((batch // share,) + tuple(pl.mask2d.shape), dtype=torch.float32,
                        device=pl.mesh.device)
    return pl.spec2d, b_spec, d_diag, zeros, DistCpadmmState(*(zeros,) * 5)


def _walk_group(op, mesh, cfg: PlanConfig, batch: int, iters: int):
    """Walk one candidate group's block at K = 1, after one warm step (the
    twiddles and the Triton kernels are built there, outside the walk)."""
    from ..launch.cost_walk import walk

    pl = _plan_with_config(op, mesh, dataclasses.replace(cfg, overlap=1))
    operands = _block_operands(pl, batch)
    pl.cpadmm_block(1)(*operands)
    return walk(pl.cpadmm_block(iters), *operands)


def _dcn_bytes(cost, cfg: PlanConfig, mesh) -> float:
    """The wire bytes of one walked block that cross a host boundary.

    A hierarchical plan sends exactly its inter-host hops as point-to-point
    operations (``"collective-permute"`` in the walk); a *flat* exchange over
    a factored (host, device) axis spanning more than one host crosses the
    boundary with its whole all-to-all payload; a plan on one axis has no
    host tier (0.0)."""
    if cfg.hier_axes is not None:
        return float(cost.collective_bytes.get("collective-permute", 0.0))
    if isinstance(cfg.axis_name, tuple) and mesh.size(cfg.axis_name[0]) > 1:
        return float(cost.collective_bytes.get("all-to-all", 0.0))
    return 0.0


def _on_one_rank(cost, cfg: PlanConfig, mesh):
    """A transform axis of one rank sends nothing over a link: its exchange
    is a copy on the device, read and written once.  -> the cost priced so."""
    if mesh.size(cfg.axis_name) > 1 or not cost.collective_bytes:
        return cost
    return dataclasses.replace(cost, bytes=cost.bytes + 2 * cost.total_collective_bytes(),
                               collective_bytes={})


def score_candidates(op, mesh, candidates: Sequence[PlanConfig], batch: int,
                     iters: int = SCORE_ITERS) -> List[Tuple[float, PlanConfig, dict]]:
    """Rank candidates by modeled block time, ascending.

    One walk per overlap group (the K sweep is analytic on it); cross-host
    bytes (:func:`_dcn_bytes`) are priced at the inter-host link's rate,
    which splits flat from hierarchical candidates on a mesh of several
    hosts.  Ties break toward the simpler config: lower overlap, then rfft
    off, then the description.  The reference needs no operator here (its
    blocks are abstract); the port's walk runs real blocks built from ``op``.
    """
    from ..launch.roofline import model_block_times

    costs: Dict[tuple, Any] = {}
    scored: List[Tuple[float, PlanConfig, dict]] = []
    for cfg in candidates:
        gk = _group_key(cfg)
        if gk not in costs:
            costs[gk] = _on_one_rank(_walk_group(op, mesh, cfg, batch, iters), cfg, mesh)
            COUNTERS["scored"] += 1
        times = model_block_times(costs[gk], cfg.overlap,
                                  dcn_bytes=_dcn_bytes(costs[gk], cfg, mesh))
        scored.append((times["modeled_total_s"], cfg, times))
    scored.sort(key=lambda t: (t[0], t[1].overlap, t[1].rfft, t[1].describe()))
    return scored


# ---------------------------------------------------------------------------
# measurement (the top candidates, timed)
# ---------------------------------------------------------------------------


def measure_config(op, mesh, cfg: PlanConfig, batch: int, iters: int = SCORE_ITERS,
                   repeats: int = MEASURE_REPEATS) -> float:
    """Seconds one candidate's concrete block takes: one warm-up, then the
    least of ``repeats`` runs, timed with CUDA events on the card and the
    host clock on the CPU.  On a mesh the slowest rank's time (every rank
    then ranks the candidates alike)."""
    pl = _plan_with_config(op, mesh, cfg)
    block = pl.cpadmm_block(iters)
    operands = _block_operands(pl, batch)
    cuda = mesh.device.type == "cuda"
    block(*operands)
    if cuda:
        torch.cuda.synchronize(mesh.device)
    best = math.inf
    for _ in range(repeats):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            block(*operands)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            block(*operands)
            best = min(best, time.perf_counter() - t0)
    slowest = torch.tensor([best], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    COUNTERS["measured"] += 1
    return float(slowest.cpu()[0])


# ---------------------------------------------------------------------------
# the tuner's entry point
# ---------------------------------------------------------------------------


def _from_rank0(obj):
    """``obj`` as rank 0 holds it, on every rank of the world."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def tuned_config(op, mesh, mode: str = "model", batch: Optional[int] = None,
                 pins: Optional[dict] = None, cache: Optional[PlanCache] = None,
                 top_k: int = 2, score_iters: int = SCORE_ITERS,
                 extra_factorizations: Sequence[Tuple[int, int]] = ()) -> PlanConfig:
    """The :class:`PlanConfig` for (op, mesh, batch), from the store or tuned.

    ``mode="model"`` ranks by the cost model alone; ``mode="measure"`` also
    times the best candidate of each of the ``top_k`` best walked groups and
    lets the time decide.  ``pins`` restrict the space and are part of the
    store's key.  With ``mesh=None`` there is nothing distributed to tune:
    the pins, validated, are the answer.  On a mesh every rank calls this;
    rank 0 alone reads and writes the store.
    """
    if mode not in ("model", "measure"):
        raise ValueError(f"tune mode must be 'model' or 'measure', got {mode!r}")
    pins = dict(pins or {})
    if mesh is None:
        return PlanConfig(**pins).validate(distributed=False)

    lead = dist.get_rank() == 0
    cache = cache if cache is not None else PlanCache()
    key = cache_key(op, mesh, batch, pins)
    hit = _from_rank0(cache.get(key) if lead else None)
    if hit is not None and (mode != "measure" or hit.get("mode") == "measure"):
        COUNTERS["cache_hits"] += 1
        return PlanConfig.from_dict(hit["config"])
    COUNTERS["cache_misses"] += 1

    cands = candidate_configs(op, mesh, pins=pins, batch=batch,
                              extra_factorizations=extra_factorizations)
    bench_batch = batch or 1
    scored = score_candidates(op, mesh, cands, batch=bench_batch, iters=score_iters)
    best_score, best_cfg, best_detail = scored[0]
    entry: dict = {
        "config": best_cfg.to_dict(),
        "mode": "model",
        "modeled_total_s": best_score,
        "candidates": len(cands),
        "detail": dict(best_detail),
        # the model's best few with their terms, so a reader of the store
        # sees the ranking without walking again
        "ranking": [{"config": c.to_dict(), "detail": dict(t)} for _, c, t in scored[:RANKING]],
    }
    if mode == "measure":
        # the best candidate of each of the top_k best groups: the model's
        # close calls between groups are what measuring is for
        picks: List[PlanConfig] = []
        seen_groups: set = set()
        for _, cfg, _ in scored:
            gk = _group_key(cfg)
            if gk in seen_groups:
                continue
            seen_groups.add(gk)
            picks.append(cfg)
            if len(picks) >= top_k:
                break
        measured = sorted(
            ((measure_config(op, mesh, cfg, bench_batch, score_iters), cfg) for cfg in picks),
            key=lambda t: t[0],
        )
        best_wall, best_cfg = measured[0]
        entry.update(config=best_cfg.to_dict(), mode="measure", measured_s=best_wall,
                     measured_top_k=[{"config": c.to_dict(), "s": s} for s, c in measured])
    if lead:
        cache.put(key, entry)
    return PlanConfig.from_dict(_from_rank0(entry["config"]))


# ---------------------------------------------------------------------------
# the store's command line
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Inspect or clear the plan-autotune store.")
    ap.add_argument("--cache", default=None, help="the store's path (default: "
                    f"$REPRO_TORCH_PLAN_CACHE or {DEFAULT_CACHE_PATH})")
    ap.add_argument("--show", action="store_true", help="print the entries")
    ap.add_argument("--clear", action="store_true", help="delete the store")
    args = ap.parse_args(argv)
    cache = PlanCache(args.cache)
    if args.clear:
        cache.clear()
        print(f"cleared {cache.path}")
        return
    entries = cache.entries()
    print(f"{cache.path}: {len(entries)} cached plan(s)")
    for key, entry in sorted(entries.items()):
        cfg = PlanConfig.from_dict(entry["config"])
        score = entry.get("measured_s", entry.get("modeled_total_s"))
        print(f"  [{entry['mode']}] {cfg.describe()}  score={score:.3e}")
        print(f"    key: {key}")


if __name__ == "__main__":
    main()
