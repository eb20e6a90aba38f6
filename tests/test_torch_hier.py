"""The hierarchical (host, device) exchange of the port, against its flat exchange.

Mirrors the hierarchical cases of ``tests/test_dist_equiv.py`` (hier == flat
for fft and rfft at every overlap K, a batch on the data axis, both
matvecs) and of ``tests/test_plan.py`` (validation, mesh extents, the
describe tags, the JSON round trip, a solve on the degenerate mesh) on the
one-rank (1, 1, 1) mesh, where the whole two-stage code path runs with no
inter-host hop; and ``tests/dist_progs/hier_prog.py`` on gloo ranks in
child processes, a (1, 2, 2) and a (2, 2, 2) (data, host, device) mesh:

* the fp32 hierarchical exchange is bit-equal to the flat one, on the same
  factored mesh and on a plain (data, model) mesh, for matvec, rmatvec and
  every K (the reference's HLO is fixed; the port compares at equal K,
  where both run the same row FFTs);
* per matvec, the intra-host all-to-all carries the flat exchange's bytes
  and the inter-host hop 1/H of them (``repro_torch.dist.fft.WIRE_BYTES``;
  at H = 2, one hop a transpose);
* bf16 inter-host hops keep the CPADMM solve within ``WIRE_ERROR_BOUND`` of
  the fp32 solve, halve the inter tier's bytes and leave the intra tier at
  fp32; demoting both tiers is no better.

The reference's tuner case (``tuned_config`` picks the hierarchical plan)
is ``tests/test_torch_tune.py::test_model_picks_hier_on_a_two_host_mesh``.
"""

import json

import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from repro_torch import interop
from repro_torch.core.circulant import partial_gaussian_circulant
from repro_torch.dist.compat import spawn_fake_devices
from repro_torch.ops.plan import WIRE_ERROR_BOUND, PlanConfig, plan

HIER_FACTORIZATIONS = [(32, 16), (16, 15), (15, 16), (15, 15)]
N1, N2 = 32, 16
SHAPES = [(1, 2, 2), (2, 2, 2)]


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


@pytest.fixture(scope="module")
def degenerate():
    x = np.random.default_rng(31).standard_normal(N1 * N2).astype(np.float32)
    return spawn_fake_devices(1, progs.hier_degenerate_program, x, HIER_FACTORIZATIONS,
                              N1, N2)[0]


@pytest.fixture(scope="module")
def meshes():
    return {shape: spawn_fake_devices(int(np.prod(shape)), progs.hier_program, shape, 300)[0]
            for shape in SHAPES}


# -- tests/test_dist_equiv.py: hier == flat on the (1, 1, 1) mesh ----------
@pytest.mark.parametrize("n1,n2", HIER_FACTORIZATIONS)
@pytest.mark.parametrize("overlap", [1, 2, 3])
def test_hier_fft_matches_flat(n1, n2, overlap, degenerate):
    got = degenerate[n1, n2, overlap]
    for name in ("fft", "ifft", "rfft", "irfft"):
        hier, flat = got[name]
        assert hier.shape == flat.shape, name
        assert torch.equal(hier, flat), name


@pytest.mark.parametrize("n1,n2", [(32, 16), (15, 16)])
def test_hier_batched_data_axis_matches_flat(n1, n2, degenerate):
    got = degenerate["batch", n1, n2]
    hier, flat = got["rfft"]
    assert hier.shape == flat.shape == (3, n1, n2 // 2 + 1)
    assert torch.equal(hier, flat)
    assert torch.equal(*got["irfft"])


@pytest.mark.parametrize("rfft", [False, True])
def test_hier_matvec_matches_flat(rfft, degenerate):
    for hier, flat in degenerate["matvec", rfft]:
        assert _rel(hier, flat) <= 1e-5


# -- tests/test_plan.py: validation, describe, JSON, the degenerate mesh ---
def _op():
    return partial_gaussian_circulant(torch.Generator().manual_seed(1), N1 * N2, N1 * N2 // 2,
                                      normalize=True, device="cpu")


def test_local_plan_rejects_hier_axes_loudly():
    with pytest.raises(ValueError, match="no mesh axes to factor"):
        plan(_op(), hier_axes=(2, 2))
    with pytest.raises(ValueError, match=r"valid values: None or a \(H, D\)"):
        PlanConfig(hier_axes=(2, 2)).validate(distributed=False)


def test_malformed_hier_axes_rejected():
    for bad in ((2,), (2, 2, 2), (2, 0), (2.0, 2), "2x2"):
        with pytest.raises(ValueError, match="hier_axes must be a"):
            PlanConfig(hier_axes=bad).validate(distributed=True)


def test_inter_wire_without_hier_rejected(degenerate):
    assert "inter_wire_dtype" in degenerate["refusals"]["inter_wire"]
    with pytest.raises(ValueError, match="inter_wire_dtype must be one of"):
        PlanConfig(hier_axes=(2, 2), inter_wire_dtype="int8").validate(distributed=True)


def test_hier_axes_must_match_mesh_extents(degenerate):
    refusals = degenerate["refusals"]
    assert "valid value: hier_axes=(1, 1)" in refusals["extents"]
    assert "make_hier_mesh" in refusals["no_pair"]  # a mesh without the pair teaches the fix


def test_hier_describe_tags_split_configs():
    base = PlanConfig(rfft=True, n1=N1, n2=N2)
    hier = PlanConfig(rfft=True, n1=N1, n2=N2, hier_axes=(2, 4), axis_name=("host", "device"))
    tflat = PlanConfig(rfft=True, n1=N1, n2=N2, axis_name=("host", "device"))
    iw = PlanConfig(rfft=True, n1=N1, n2=N2, hier_axes=(2, 4), axis_name=("host", "device"),
                    inter_wire_dtype="bf16")
    assert "hier=" not in base.describe()
    assert "hier=2x4" in hier.describe()
    assert "hier=flat" in tflat.describe()  # a factored axis, one flat all-to-all
    assert "inter_wire=bf16" in iw.describe()
    assert len({c.describe() for c in (base, hier, tflat, iw)}) == 4


def test_hier_config_round_trips_through_json():
    cfg = PlanConfig(rfft=True, n1=N1, n2=N2, hier_axes=(2, 4), axis_name=("host", "device"),
                     inter_wire_dtype="bf16")
    again = PlanConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert again == cfg
    assert isinstance(again.hier_axes, tuple) and isinstance(again.axis_name, tuple)


def test_hier_describe_is_the_reference_tag():
    from repro.ops import PlanConfig as RefConfig

    knobs = dict(rfft=True, n1=N1, n2=N2, hier_axes=(2, 4), axis_name=("host", "device"),
                 inter_wire_dtype="bf16")
    ref = RefConfig(**knobs)
    assert PlanConfig(**knobs).describe() == ref.describe().replace("tail=jnp", "tail=plain")
    assert interop.plan_config_from_reference_dict(
        json.loads(json.dumps(ref.to_dict()))) == PlanConfig(**knobs)


def test_hier_plan_solves_on_degenerate_mesh(degenerate):
    """The 1x1 (host, device) mesh runs the full hierarchical path; its solve
    equals the flat plan's bit for bit."""
    got = degenerate["solve"]
    assert got["hier"] and got["axis_name"] == ("host", "device")
    assert torch.equal(*got["x"])


# -- tests/dist_progs/hier_prog.py on gloo ranks ----------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fp32_hier_is_bit_exact_with_flat(shape, meshes):
    out = meshes[shape]
    for rfft in (False, True):
        for K in (1, 2, 4):
            got = out[rfft, K]
            assert got["flat"] and got["hier"] and got["rmatvec"], (rfft, K)
            assert got["axis_name"] == ("host", "device")
            assert f"hier={shape[1]}x{shape[2]}" in got["describe"]
    assert torch.equal(out["solve", "hier"], out["solve", "flat"])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_inter_host_hop_carries_one_over_h_of_the_bytes(shape, meshes):
    H = shape[1]
    out = meshes[shape]
    for rfft in (False, True):
        flat, hier = out[rfft, "bytes", "flat"], out[rfft, "bytes", "hier"]
        assert flat["intra"] == flat["inter"] == 0 and flat["flat"] > 0
        assert hier["flat"] == 0
        assert hier["intra"] == flat["flat"]  # the whole payload within the host
        assert hier["inter"] * H == flat["flat"]  # one hop at H = 2, 1/H of the bytes


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_inter_wire_within_the_guard_bound(shape, meshes):
    out = meshes[shape]
    assert out["wires", "inter16"] == ("fp32", "bf16")  # the guard kept the demoted hop
    x32, x16, xb = out["solve", "hier"], out["solve", "inter16"], out["solve", "both16"]
    rel16, relb = _rel(x16, x32), _rel(xb, x32)
    assert 0 < rel16 <= WIRE_ERROR_BOUND, rel16
    assert rel16 <= relb * 1.5 + 1e-12, (rel16, relb)  # demoting 1/H is no worse than all


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_inter_wire_halves_the_inter_tier_bytes(shape, meshes):
    out = meshes[shape]
    inter16, hier = out["bytes", "inter16"], out["bytes", "hier"]
    assert inter16["intra"] == hier["intra"]  # the intra tier stays fp32
    assert inter16["inter"] * 2 == hier["inter"]
