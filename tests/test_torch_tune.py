"""The port's plan autotuner (``repro_torch.ops.tune``) against the reference's.

Mirrors every case of ``tests/test_tune.py``: the store (warm hits skip
all scoring, a model entry does not serve a measure request, pins key
their own entries, atomic merged writes, quarantine), the candidate space
and its pins, the group keys, the DCN policy, the two-tier model, and a
measure-tuned plan's solve.  The reference scores abstract HLO; the port
walks concrete blocks (``repro_torch.launch.cost_walk``), so its HLO-bound
cases become walk cases:

* ``test_overlap_sweep_shares_one_compile``: one walk per overlap group;
* ``test_rfft_beats_full_complex_at_4096_squared``: at the paper's 1024 x
  1024 frame (n = 2^20), which the CPU walks in a few tenths of a second;
* ``test_one_device_tie_breaks_to_fp32_wire``: on a one-rank axis the walk
  prices the exchange as a copy on the device, so fp32 wins outright over
  bf16's pack and unpack;
* the ``_group_key`` splits, unchanged.

``test_plan_tune_rejects_full_config`` has no counterpart: the port's
``plan()`` has no ``config=`` spelling (ROADMAP Queue 3).

Beside the mirrors, the port is held against the reference in one process:
the candidate lists (tails ``jnp`` -> ``plain``), ``_dcn_bytes``, and
``model_block_times`` priced at the reference's constants (read from
``repro.launch.roofline`` here, never written into the port) with the
launch term zeroed.  The mesh cases run on gloo ranks in child processes
(``tests/torch_mesh_programs.py``): one rank for the walked and timed
cases, ``tests/dist_progs/autotune_prog.py`` on 4 ranks, and
``hier_prog.py``'s tuner case on a (2, 2, 2) hierarchical mesh (8 frames
of 1024 x 1024, where the bytes outweigh the two-stage exchange's launches).  The
deprecated ``make_dist_cpadmm`` shim's cases of ``tests/test_plan.py`` are
here too, and one ``gpu`` case holds a kernel-tail walk's launches against
the wrappers' counters.
"""

import dataclasses
import os
import types
import warnings

import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from repro_torch import interop
from repro_torch.dist.compat import Mesh, spawn_fake_devices
from repro_torch.kernels import report_launch
from repro_torch.launch import cost_walk, roofline
from repro_torch.ops import tune
from repro_torch.ops.plan import WIRE_ERROR_BOUND, PlanConfig, plan

N1, N2 = 32, 16
N = N1 * N2
KW = dict(alpha=1e-4, rho=0.01, sigma=0.01)
ITERS = 150


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _meta_mesh(shape, names, device="cpu") -> Mesh:
    """A mesh's names and extents with no process group behind them: all
    that candidate enumeration, the store's key and the DCN policy read."""
    return Mesh(tuple(names), tuple(shape), (0,) * len(shape), (None,) * len(shape),
                torch.device(device))


@pytest.fixture(autouse=True)
def _fresh_counters():
    tune.reset_counters()
    yield


@pytest.fixture
def cache(tmp_path):
    return tune.PlanCache(str(tmp_path / "plan_cache.json"))


def _ref_arrays(n1, n2, batch):
    """The reference's problem (``tests/test_tune.py``'s draws) as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.core.circulant import PartialCirculant, gaussian_circulant
    from repro.data.synthetic import paper_regime, sparse_signal

    n = n1 * n2
    m, k = paper_regime(n)
    x = sparse_signal(jax.random.PRNGKey(0), n, k, batch=batch)
    C = gaussian_circulant(jax.random.PRNGKey(1), n, normalize=True)
    omega = jnp.sort(jax.random.permutation(jax.random.PRNGKey(2), n)[:m]).astype(jnp.int32)
    op = PartialCirculant(C, omega)
    arrays = dict(col=np.asarray(C.col), spec=np.asarray(C.spec), omega=np.asarray(omega),
                  y=np.asarray(op.matvec(x)), x_true=np.asarray(x), n1n2=(n1, n2))
    return op, arrays


@pytest.fixture(scope="module")
def ref():
    """The reference's 512-point problem with 2 signals and its one-device
    CPADMM answer; the port's operator from the same arrays."""
    pytest.importorskip("jax")
    from repro.core import RecoveryProblem, solve

    ref_op, a = _ref_arrays(N1, N2, (2,))
    prob = RecoveryProblem(op=ref_op, y=a["y"], x_true=a["x_true"])
    x, _ = solve(prob, "cpadmm", iters=ITERS, record_every=ITERS, **KW)
    op = interop.partial_circulant_from_numpy(a["col"], a["spec"], a["omega"], device="cpu")
    return dict(arrays=a, ref_op=ref_op, op=op, x=np.asarray(x))


@pytest.fixture(scope="module")
def one_rank(ref, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("tune_one_rank") / "plan_cache.json")
    out = spawn_fake_devices(1, progs.tune_one_rank_program, ref["arrays"], store, KW, ITERS)[0]
    return dict(out, store=store)


# ---------------------------------------------------------------------------
# the store: round trips, warm hits skip everything
# ---------------------------------------------------------------------------


def test_warm_cache_hit_skips_all_scoring_and_is_bit_identical(one_rank):
    assert one_rank["cold/counters"]["cache_misses"] == 1
    assert one_rank["cold/counters"]["scored"] > 0
    assert one_rank["warm"] == one_rank["cold"]  # frozen dataclass equality: every knob
    assert one_rank["warm/counters"] == {
        "scored": 0, "measured": 0, "cache_hits": 1, "cache_misses": 0,
    }
    # the entry keeps the model's best few with their terms, its pick first
    (entry,) = tune.PlanCache(one_rank["store"]).entries().values()
    ranking = entry["ranking"]
    assert ranking[0]["config"] == one_rank["cold"].to_dict()
    assert len(ranking) == min(tune.RANKING, entry["candidates"])
    totals = [r["detail"]["modeled_total_s"] for r in ranking]
    assert totals == sorted(totals) and totals[0] == entry["modeled_total_s"]


def test_config_json_round_trip_is_lossless(cache):
    cfg = PlanConfig(rfft=True, overlap=4, tail="kernel", fused=False,
                     batch_axis=("pod", "data"), n1=64, n2=128)
    assert PlanConfig.from_dict(cfg.to_dict()) == cfg
    cache.put("k", {"config": cfg.to_dict(), "mode": "model"})
    assert PlanConfig.from_dict(cache.get("k")["config"]) == cfg


def test_model_entry_does_not_satisfy_measure_request(one_rank):
    assert one_rank["model/counters"]["cache_misses"] == 1
    measure = one_rank["measure/counters"]
    assert measure["cache_misses"] == 1 and measure["measured"] > 0
    # ...but a measure entry serves both modes
    both = one_rank["both/counters"]
    assert both["cache_hits"] == 2 and both["scored"] == 0


def test_pins_are_part_of_the_cache_key(ref, one_rank):
    mesh = _meta_mesh((1,), ("model",))
    assert tune.cache_key(ref["op"], mesh, 2, {}) != tune.cache_key(ref["op"], mesh, 2,
                                                                   {"rfft": True})
    assert one_rank["pinned"].rfft is False  # the pin survives into the winner


def test_cache_key_names_the_torch_version_and_device(ref):
    key = tune.cache_key(ref["op"], _meta_mesh((1,), ("model",)), 2, {})
    assert f"torch={torch.__version__}" in key and "device=cpu" in key
    assert "jax=" not in key and "backend=" not in key


def test_default_store_is_the_ports_own(monkeypatch, tmp_path):
    from repro.ops import tune as ref_tune

    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE", raising=False)
    assert tune.PlanCache().path == os.path.join("artifacts", "plan_cache_torch.json")
    assert tune.PlanCache().path != ref_tune.DEFAULT_CACHE_PATH
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "reference.json"))
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "port.json"))
    assert tune.PlanCache().path == str(tmp_path / "port.json")


# ---------------------------------------------------------------------------
# the cost model's ranking on walked blocks
# ---------------------------------------------------------------------------


def test_rfft_beats_full_complex_at_4096_squared(one_rank):
    """The half-spectrum path moves fewer bytes for the same launches; at
    the paper's 1024 x 1024 frame the walk must rank it first."""
    (s_first, rfft_first), (s_second, _) = one_rank["rfft"]
    assert rfft_first is True and s_first < s_second
    assert one_rank["rfft/counters"]["scored"] == 2


def test_overlap_sweep_shares_one_compile(one_rank):
    assert len(one_rank["overlap"]) == 4
    assert one_rank["overlap/counters"]["scored"] == 1  # one walk, the K sweep analytic
    # on a one-rank axis nothing crosses a link: ties break toward overlap=1
    assert one_rank["overlap"][0][1] == 1


def test_one_device_tie_breaks_to_fp32_wire(one_rank):
    """A one-rank axis sends nothing over a link, so a demoted wire saves
    nothing and adds its pack and unpack: fp32 ranks first."""
    assert one_rank["wire"][0][1] == "fp32"
    assert one_rank["wire/counters"]["scored"] == 2  # the wire splits the walk group


# ---------------------------------------------------------------------------
# the candidate space and its pins
# ---------------------------------------------------------------------------


def test_candidate_configs_honor_pins(ref):
    op, mesh = ref["op"], _meta_mesh((1,), ("model",))
    free = tune.candidate_configs(op, mesh)
    assert {c.rfft for c in free} == {False, True}
    assert {c.overlap for c in free} == set(tune.OVERLAPS)
    pinned = tune.candidate_configs(op, mesh, pins={"rfft": True, "overlap": 2})
    assert all(c.rfft and c.overlap == 2 for c in pinned)
    n1_pinned = tune.candidate_configs(op, mesh, pins={"n1": 16})
    assert all(c.n1 == 16 and c.n2 == N // 16 for c in n1_pinned)


def test_candidate_configs_reject_unknown_axis(ref):
    with pytest.raises(ValueError, match="axis_name"):
        tune.candidate_configs(ref["op"], _meta_mesh((1,), ("model",)),
                               pins={"axis_name": "pod"})


def test_extra_factorizations_filtered_by_divisibility(ref):
    cands = tune.candidate_configs(
        ref["op"], _meta_mesh((1,), ("model",)), pins={"rfft": True, "overlap": 1},
        extra_factorizations=[(N1, N2), (7, 11)],  # (7, 11) is not n: dropped
    )
    facs = {(c.n1, c.n2) for c in cands}
    assert (N1, N2) in facs and (7, 11) not in facs


def test_candidate_tails_follow_the_mesh_device(ref):
    """Both tails on a card, the plain one elsewhere (the reference: both
    on a TPU, jnp elsewhere); a tail pin holds on either."""
    cpu, card = _meta_mesh((1,), ("model",)), _meta_mesh((1,), ("model",), "cuda")
    assert {c.tail for c in tune.candidate_configs(ref["op"], cpu)} == {"plain"}
    assert {c.tail for c in tune.candidate_configs(ref["op"], card)} == {"plain", "kernel"}
    assert {c.tail for c in tune.candidate_configs(ref["op"], cpu,
                                                   pins={"tail": "kernel"})} == {"kernel"}


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_tuned_config_rejects_unknown_mode():
    with pytest.raises(ValueError, match="model.*measure"):
        tune.tuned_config(None, None, mode="guess")


def test_local_tune_is_the_pins():
    cfg = tune.tuned_config(None, None, pins={"tail": "kernel"})
    assert cfg == PlanConfig(tail="kernel")
    assert tune.COUNTERS["scored"] == 0  # nothing distributed to score


def test_local_plan_tune_resolves_the_tail_from_the_operator(ref):
    pl = plan(ref["op"], tune=True)
    assert pl.config == PlanConfig(tail="plain") and pl.operator is ref["op"]
    assert tune.COUNTERS == {"scored": 0, "measured": 0, "cache_hits": 0, "cache_misses": 0}
    with pytest.raises(ValueError, match="distributed-backend knobs"):
        plan(ref["op"], tune=True, rfft=True)


def test_measure_mode_plan_solves_correctly(ref, one_rank):
    """A measure-tuned plan drives the same solve as the untuned plan and as
    the reference's one device (its warm rebuild gives the same config)."""
    assert one_rank["measured"] > 0
    tol = 1e-5 if one_rank["tuned/wire"] == "fp32" else WIRE_ERROR_BOUND
    assert _rel(one_rank["tuned/x"], one_rank["untuned/x"]) <= tol
    assert _rel(one_rank["tuned/x"], ref["x"]) <= tol
    assert _rel(one_rank["untuned/x"], ref["x"]) <= 1e-5
    assert one_rank["rebuilt/config"] == one_rank["tuned/config"]


def test_cache_cli_show_and_clear(one_rank, tmp_path, capsys):
    store = tmp_path / "plan_cache.json"
    store.write_text(open(one_rank["store"]).read())
    tune.main(["--cache", str(store), "--show"])
    out = capsys.readouterr().out
    assert "1 cached plan" in out and "[model]" in out and "device=cpu" in out
    tune.main(["--cache", str(store), "--clear"])
    assert tune.PlanCache(str(store)).entries() == {}


def test_group_key_ignores_overlap_only():
    a = PlanConfig(rfft=True, overlap=1, n1=8, n2=8)
    b = dataclasses.replace(a, overlap=8)
    c = dataclasses.replace(a, rfft=False)
    assert tune._group_key(a) == tune._group_key(b)
    assert tune._group_key(a) != tune._group_key(c)


# ---------------------------------------------------------------------------
# the store's durability: concurrent writers merge, corrupt stores quarantine
# ---------------------------------------------------------------------------


def _entry(tag):
    return {"config": PlanConfig(n1=8, n2=8).to_dict(), "mode": "model",
            "modeled_total_s": 1.0, "tag": tag}


def test_concurrent_puts_merge_instead_of_dropping(tmp_path):
    path = str(tmp_path / "plan_cache.json")
    a, b = tune.PlanCache(path), tune.PlanCache(path)
    a._race_hook = lambda: tune.PlanCache.put(b, "key_b", _entry("b"))
    a.put("key_a", _entry("a"))
    entries = tune.PlanCache(path).entries()
    assert set(entries) == {"key_a", "key_b"}
    assert entries["key_a"]["tag"] == "a" and entries["key_b"]["tag"] == "b"


def test_concurrent_same_key_put_is_last_writer_wins(tmp_path):
    path = str(tmp_path / "plan_cache.json")
    a, b = tune.PlanCache(path), tune.PlanCache(path)
    a._race_hook = lambda: tune.PlanCache.put(b, "key", _entry("b"))
    a.put("key", _entry("a"))  # a's rename lands after b's
    assert tune.PlanCache(path).entries()["key"]["tag"] == "a"


def test_corrupt_cache_quarantined_with_one_time_warning(tmp_path):
    path = str(tmp_path / "plan_cache.json")
    with open(path, "w") as f:
        f.write("{ not json !!")
    cache = tune.PlanCache(path)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert cache.entries() == {}
    assert os.path.exists(path + ".corrupt")
    assert not os.path.exists(path)
    with open(path, "w") as f:
        f.write("[1, 2, 3]")  # parses, but not to a dict: corrupt too
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once per path per process
        assert cache.get("anything") is None
    cache.put("k", _entry("fresh"))
    assert cache.get("k")["tag"] == "fresh"


def test_missing_cache_file_is_silently_empty(tmp_path):
    cache = tune.PlanCache(str(tmp_path / "nope.json"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cache.entries() == {}


def test_candidate_configs_sweep_wire_dtypes(ref):
    mesh = _meta_mesh((1,), ("model",))
    free = tune.candidate_configs(ref["op"], mesh)
    assert {c.wire_dtype for c in free} == {"fp32", "bf16"}
    pinned = tune.candidate_configs(ref["op"], mesh, pins={"wire_dtype": "fp32"})
    assert {c.wire_dtype for c in pinned} == {"fp32"}
    fp16 = tune.candidate_configs(ref["op"], mesh, pins={"wire_dtype": "fp16"})
    assert {c.wire_dtype for c in fp16} == {"fp16"}


def test_group_key_splits_on_wire_dtype():
    a = PlanConfig(rfft=True, overlap=1, n1=8, n2=8)
    w = dataclasses.replace(a, wire_dtype="bf16")
    assert tune._group_key(a) != tune._group_key(w)
    assert tune._group_key(w) == tune._group_key(dataclasses.replace(w, overlap=4))


# ---------------------------------------------------------------------------
# hierarchical candidates and the two-tier model
# ---------------------------------------------------------------------------

HIER = ("data", "host", "device")


def test_factored_mesh_auto_enumerates_flat_and_hier(ref):
    mesh = _meta_mesh((1, 1, 1), HIER)
    cands = tune.candidate_configs(ref["op"], mesh)
    assert {c.hier_axes for c in cands} == {None, (1, 1)}
    assert all(c.axis_name == ("host", "device") for c in cands)
    assert {c.inter_wire_dtype for c in cands if c.hier_axes is None} == {"fp32"}
    assert {c.inter_wire_dtype for c in cands if c.hier_axes is not None} == {"fp32", "bf16"}
    pinned = tune.candidate_configs(ref["op"], mesh, pins={"hier_axes": (1, 1)})
    assert {c.hier_axes for c in pinned} == {(1, 1)}
    flat = tune.candidate_configs(ref["op"], _meta_mesh((1,), ("model",)))
    assert {c.hier_axes for c in flat} == {None}


def test_inter_wire_pin_drops_flat_candidates(ref):
    cands = tune.candidate_configs(ref["op"], _meta_mesh((1, 1, 1), HIER),
                                   pins={"inter_wire_dtype": "bf16"})
    assert cands and all(c.hier_axes == (1, 1) for c in cands)
    with pytest.raises(ValueError, match="hierarchical candidate space"):
        tune.candidate_configs(ref["op"], _meta_mesh((1,), ("model",)),
                               pins={"inter_wire_dtype": "bf16"})


def test_group_key_splits_on_hier_and_inter_wire():
    a = PlanConfig(rfft=True, overlap=1, n1=8, n2=8, axis_name=("host", "device"))
    h = dataclasses.replace(a, hier_axes=(2, 4))
    hw = dataclasses.replace(h, inter_wire_dtype="bf16")
    assert len({tune._group_key(c) for c in (a, h, hw)}) == 3
    assert tune._group_key(h) == tune._group_key(dataclasses.replace(h, overlap=4))


class _Cost:
    collective_bytes = {"all-to-all": 1000.0, "collective-permute": 250.0}


def test_dcn_bytes_policy():
    mesh_h = _meta_mesh((1, 1, 1), HIER)
    hier = PlanConfig(hier_axes=(1, 1), axis_name=("host", "device"))
    tflat = PlanConfig(axis_name=("host", "device"))
    assert tune._dcn_bytes(_Cost(), hier, mesh_h) == 250.0
    assert tune._dcn_bytes(_Cost(), tflat, mesh_h) == 0.0  # H = 1: never leaves the host
    assert tune._dcn_bytes(_Cost(), tflat, _meta_mesh((1, 2, 2), HIER)) == 1000.0
    assert tune._dcn_bytes(_Cost(), PlanConfig(), _meta_mesh((1,), ("model",))) == 0.0


def test_two_tier_model_ranks_hier_above_flat():
    """A hierarchical block (the whole payload within hosts, 1/H across)
    must beat the flat block (the whole payload across) whenever the
    inter-host link is slower than NVLINK_BW / H."""

    def cost(**wire):
        return cost_walk.Cost(flops=1e9, bytes=1e6, collective_bytes=wire)

    B, H = 8e8, 2
    assert roofline.INTER_HOST_BW < roofline.NVLINK_BW / H
    t_flat = roofline.model_block_times(cost(**{"all-to-all": B}), dcn_bytes=B)
    t_hier = roofline.model_block_times(
        cost(**{"all-to-all": B, "collective-permute": B / H}), dcn_bytes=B / H)
    assert t_hier["collective_s"] < t_flat["collective_s"]
    assert t_hier["dcn_collective_s"] == pytest.approx(t_flat["dcn_collective_s"] / H)
    t0 = roofline.model_block_times(cost(**{"all-to-all": B}))
    assert t0["collective_s"] == B / roofline.NVLINK_BW == t0["ici_collective_s"]
    assert t0["dcn_collective_s"] == 0.0


# ---------------------------------------------------------------------------
# the port against the reference, in this process
# ---------------------------------------------------------------------------

# (mesh shape, axis names, batch, pins)
SPACES = [
    ((1,), ("model",), None, {}),
    ((1,), ("model",), 2, {"rfft": True, "overlap": 2}),
    ((1,), ("model",), None, {"n1": 16}),
    ((4,), ("model",), None, {"wire_dtype": "fp16"}),
    ((2, 2), ("data", "model"), 4, {}),
    ((2, 2), ("data", "model"), 3, {"fused": False}),
    ((2, 2), ("data", "model"), 4, {"batch_axis": "data", "rfft": False}),
    ((2, 2, 2), HIER, 2, {}),
    ((2, 2, 2), HIER, 2, {"inter_wire_dtype": "bf16"}),
    ((1, 2, 2), HIER, 2, {"hier_axes": (2, 2), "n1": 32}),
]


def _ref_mesh(shape, names):
    return types.SimpleNamespace(axis_names=tuple(names), shape=dict(zip(names, shape)))


@pytest.mark.parametrize("shape,names,batch,pins", SPACES)
def test_candidate_configs_match_the_reference(shape, names, batch, pins, ref):
    from repro.ops import tune as ref_tune

    extra = [(N1, N2), (16, 32)]
    want = ref_tune.candidate_configs(ref["ref_op"], _ref_mesh(shape, names), pins=pins,
                                      batch=batch, extra_factorizations=extra)
    got = tune.candidate_configs(ref["op"], _meta_mesh(shape, names), pins=pins, batch=batch,
                                 extra_factorizations=extra)
    as_port = [dict(c.to_dict(), tail={"jnp": "plain", "pallas": "kernel"}[c.tail])
               for c in want]
    assert [c.to_dict() for c in got] == as_port


@pytest.mark.parametrize("shape,names,cfg", [
    ((1, 1, 1), HIER, dict(hier_axes=(1, 1), axis_name=("host", "device"))),
    ((1, 2, 2), HIER, dict(axis_name=("host", "device"))),
    ((2, 2, 2), HIER, dict(hier_axes=(2, 2), axis_name=("host", "device"))),
    ((1, 1, 1), HIER, dict(axis_name=("host", "device"))),
    ((4,), ("model",), {}),
])
def test_dcn_bytes_match_the_reference(shape, names, cfg):
    from repro.ops import PlanConfig as RefPlanConfig
    from repro.ops import tune as ref_tune

    rng = np.random.default_rng(len(shape) + sum(shape))
    for _ in range(5):
        c = _Cost()
        c.collective_bytes = {"all-to-all": float(rng.integers(1, 1 << 30)),
                              "collective-permute": float(rng.integers(0, 1 << 28))}
        assert tune._dcn_bytes(c, PlanConfig(**cfg), _meta_mesh(shape, names)) == \
            ref_tune._dcn_bytes(c, RefPlanConfig(**cfg), _ref_mesh(shape, names))


@pytest.mark.parametrize("seed", range(6))
def test_model_block_times_match_the_reference_at_its_constants(seed):
    import repro.launch.roofline as ref_roofline

    rng = np.random.default_rng(seed)
    # the two collectives the walk reports
    wire = {k: float(rng.uniform(0, 1e9))
            for k in ("all-to-all", "collective-permute")[:1 + seed % 2]}
    cost = cost_walk.Cost(flops=float(rng.uniform(0, 1e12)), bytes=float(rng.uniform(0, 1e10)),
                          collective_bytes=wire, launches=int(rng.integers(1, 500)))
    for overlap in (1, 2, 4, 8):
        dcn = float(rng.uniform(0, 1.5)) * cost.total_collective_bytes()
        want = ref_roofline.model_block_times(cost, overlap, dcn_bytes=dcn)
        got = roofline.model_block_times(
            cost, overlap, dcn_bytes=dcn, peak_flops=ref_roofline.PEAK_FLOPS,
            hbm_bw=ref_roofline.HBM_BW, link_bw=ref_roofline.ICI_BW,
            inter_host_bw=ref_roofline.DCN_BW, launch_floor_s=0.0)
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-12, abs=0.0), key
        assert got["launch_s"] == 0.0


def test_launch_term_prices_every_launch_at_the_floor():
    cost = cost_walk.Cost(flops=0.0, bytes=3.35e6, launches=18)
    t = roofline.model_block_times(cost)
    assert t["launch_s"] == 18 * roofline.LAUNCH_FLOOR_S
    assert t["modeled_total_s"] == pytest.approx(1e-6 + 18 * roofline.LAUNCH_FLOOR_S)
    # five more launches moving the same bytes cost five floors more
    more = roofline.model_block_times(dataclasses.replace(cost, launches=23))
    assert more["modeled_total_s"] - t["modeled_total_s"] == pytest.approx(
        5 * roofline.LAUNCH_FLOOR_S)


# ---------------------------------------------------------------------------
# the cost walk
# ---------------------------------------------------------------------------


def test_walk_counts_bytes_flops_and_launches():
    x = torch.randn(4, 256)

    def fn(x):
        y = x * 2.0  # 4 KiB read, 4 KiB written
        f = torch.fft.rfft(y, dim=-1)  # real: 2.5 N log2 N a signal
        return y.reshape(-1).view(4, 256), f  # views: nothing

    cost = cost_walk.walk(fn, x)
    assert cost.launches == 2
    assert cost.bytes == 4 * 1024 * 2 + 4 * 1024 + 4 * 129 * 8
    assert cost.flops == pytest.approx(0.5 * 5 * 4 * 256 * 8)
    assert cost.collective_bytes == {}


def test_walk_counts_matrix_products_by_the_flop_counters_rules():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    cost = cost_walk.walk(torch.mm, a, b)
    assert cost.flops == 2 * 8 * 16 * 4 and cost.launches == 1
    assert cost.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def test_walk_hears_the_kernel_reports_and_nothing_else_does():
    x, out = torch.ones(100), torch.ones(50)
    report_launch("cpadmm_tail", x, out)  # no walk running: a no-op
    cost = cost_walk.walk(lambda: report_launch("cpadmm_tail", x, out))
    assert cost.kernel_launches == {"cpadmm_tail": 1} and cost.launches == 1
    assert cost.bytes == 600
    from repro_torch import kernels

    assert kernels._launch_hook is None


# ---------------------------------------------------------------------------
# mesh cases on gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def autotune(tmp_path_factory):
    """``tests/dist_progs/autotune_prog.py`` on 4 gloo ranks (n = 32 x 32,
    one signal), with the reference's one-device solve."""
    pytest.importorskip("jax")
    from repro.core import RecoveryProblem, solve

    ref_op, a = _ref_arrays(32, 32, ())
    prob = RecoveryProblem(op=ref_op, y=a["y"], x_true=a["x_true"])
    x, _ = solve(prob, "cpadmm", iters=300, record_every=300, **KW)
    store = str(tmp_path_factory.mktemp("autotune") / "plan_cache.json")
    ranks = spawn_fake_devices(4, progs.tune_autotune_program, a, store, KW, 300)
    return dict(ranks=ranks, x=np.asarray(x))


def test_autotune_solve_matches_untuned_on_four_ranks(autotune):
    r = autotune["ranks"][0]
    assert r["cold"]["scored"] > 0 and r["cold"]["cache_misses"] == 1
    tol = 1e-5 if r["tuned"].wire_dtype == "fp32" else WIRE_ERROR_BOUND
    assert _rel(r["x/tuned"], r["x/default"]) <= tol
    assert _rel(r["x/default"], autotune["x"]) <= 1e-5
    # an fp32 wire pin restores the exact contract
    assert r["pinned"].wire_dtype == "fp32"
    assert _rel(r["x/pinned"], r["x/default"]) <= 1e-5
    assert _rel(r["x/pinned"], autotune["x"]) <= 1e-5


def test_autotune_rfft_is_the_cheaper_wire_and_the_pick(autotune):
    r = autotune["ranks"][0]
    assert r["a2a/True"] < r["a2a/False"]
    assert r["tuned"].rfft


def test_autotune_warm_hit_and_one_config_on_every_rank(autotune):
    ranks = autotune["ranks"]
    for r in ranks:
        assert r["warm"] == r["tuned"] == ranks[0]["tuned"]
        assert r["pinned"] == ranks[0]["pinned"]
        assert r["warm/counters"] == {"scored": 0, "measured": 0, "cache_hits": 1,
                                      "cache_misses": 0}
    # rank 0 alone writes the store: once for each of the two tunes
    assert [r["puts"] for r in ranks] == [2, 0, 0, 0]


def test_model_picks_hier_on_a_two_host_mesh(tmp_path):
    """``hier_prog.py``'s tuner case: on (2, 2, 2) the two-tier model picks
    the hierarchical exchange unaided, and every rank picks it.  At 8
    frames of the paper's 1024 x 1024: at hier_prog's 32 x 32 (and at 2
    such frames) the two-stage exchange's 8 extra launches a step outweigh
    the inter-host bytes it saves, and the port's model, which prices
    launches, keeps the flat exchange there."""
    store = str(tmp_path / "plan_cache.json")
    picks = spawn_fake_devices(8, progs.tune_hier_program, 1024, 1024, 8, store, 2)
    assert picks[0].hier_axes == (2, 2), picks[0]
    assert all(p == picks[0] for p in picks)


# ---------------------------------------------------------------------------
# the deprecated make_dist_cpadmm shim (tests/test_plan.py)
# ---------------------------------------------------------------------------


def test_make_dist_cpadmm_shim_warns_and_matches_plan_route(ref):
    out = spawn_fake_devices(1, progs.shim_program, ref["arrays"], KW, ITERS)[0]
    assert any(cat == "DeprecationWarning" and "make_dist_cpadmm is deprecated" in msg
               for cat, msg in out["warned"])
    assert _rel(out["shim"], out["plan"]) <= 1e-6
    assert _rel(out["plan"], ref["x"]) <= 1e-5


def test_shim_rejects_unknown_batch_axis():
    from repro_torch.dist.recovery import make_dist_cpadmm

    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="batch_axis"):
            make_dist_cpadmm(_meta_mesh((1,), ("model",)), N1, N2, 10, batch_axis="data")


def test_shim_warning_pins_removal_version():
    from repro_torch.dist.recovery import make_dist_cpadmm

    with pytest.warns(DeprecationWarning, match=r"make_dist_cpadmm is deprecated and will be "
                                                r"removed in repro_torch 0\.2\.0"):
        make_dist_cpadmm(_meta_mesh((1,), ("model",)), N1, N2, 1)


def test_make_dist_cpadmm_not_exported_from_dist_package():
    import repro_torch.dist as dist
    from repro_torch.dist.compat import make_mesh

    assert "make_dist_cpadmm" not in dist.__all__
    assert "make_dist_cpadmm" not in dir(dist)
    with pytest.raises(AttributeError, match="make_dist_cpadmm"):
        dist.make_dist_cpadmm
    assert dist.MODEL_AXIS == "model"
    assert dist.make_mesh is make_mesh
    assert callable(dist.dist_cpadmm_step)
    assert set(dist.__all__) >= {"layout_2d", "make_distributed_rfft", "DistCpadmmParams"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_tail_walk_hears_every_kernel_launch_on_card():
    """A kernel-tail block's walk hears each wrapper's launch: its kernel
    counts equal the wrappers' counters over the same call (fp32 and bf16
    wires, one gloo rank holding its blocks on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels launch only on the card")
    out = spawn_fake_devices(1, progs.kernel_walk_program, 256, 4, device="cuda:0")[0]
    for wire, r in out.items():
        assert r["heard"] == r["counted"], wire
        assert r["counted"]["cpadmm_tail"] == 4
    assert out["bf16"]["counted"]["pack_wire"] == out["bf16"]["counted"]["unpack_wire"] > 0
