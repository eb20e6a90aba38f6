"""``PlanConfig.to_dict`` / ``from_dict`` / ``describe`` on the port.

Mirrors the local ``PlanConfig`` cases of ``tests/test_plan.py`` (frozen and
hashable, the wire tag, the JSON round trip) and the map-making plan's tag
of ``tests/test_mapmaking.py``.  ``describe()`` is held against the
reference's string for the same knobs, with the port's tail names (the
reference's ``jnp`` / ``pallas`` are ``plain`` / ``kernel``), and the
reference's ``to_dict()`` output rebuilds the port's config through
``repro_torch.interop.plan_config_from_reference_dict``.
"""

import json

import jax
import pytest
import torch

from repro.ops import PlanConfig as RefConfig
from repro.ops.prox import TVProx as RefTV
from repro.ops.prox import WaveletProx as RefWavelet
from repro_torch import interop
from repro_torch.core.circulant import partial_gaussian_circulant
from repro_torch.ops.plan import PlanConfig, plan
from repro_torch.ops.prox import TVProx, WaveletProx

N1, N2 = 32, 16
_PORT_TAIL = {"jnp": "plain", "pallas": "kernel"}

# (port knobs, the reference's knobs for the same plan)
CONFIGS = {
    "default": ({}, {}),
    "rfft-overlap": (dict(rfft=True, overlap=2, n1=N1, n2=N2),
                     dict(rfft=True, overlap=2, n1=N1, n2=N2)),
    "kernel-unfused": (dict(tail="kernel", fused=False), dict(tail="pallas", fused=False)),
    "batch-wire": (dict(batch_axis="data", wire_dtype="bf16", rfft=True),
                   dict(batch_axis="data", wire_dtype="bf16", rfft=True)),
    "tv": (dict(prox=TVProx(shape=(8, 8), iters=5)), dict(prox=RefTV(shape=(8, 8), iters=5))),
    "wavelet": (dict(prox=WaveletProx(levels=1, wavelet="db4"), n1=N1, n2=N2),
                dict(prox=RefWavelet(levels=1, wavelet="db4"), n1=N1, n2=N2)),
}


def _ref_describe(ref: RefConfig) -> str:
    tail = ref.tail
    return ref.describe().replace(f"tail={tail}", f"tail={_PORT_TAIL[tail]}")


def test_plan_config_is_frozen_and_hashable():
    cfg = PlanConfig(rfft=True, overlap=2, n1=N1, n2=N2)
    assert hash(cfg) == hash(PlanConfig(rfft=True, overlap=2, n1=N1, n2=N2))
    with pytest.raises(Exception):  # dataclasses.FrozenInstanceError
        cfg.rfft = False
    assert "rfft=on" in cfg.describe() and "overlap=2" in cfg.describe()


def test_plan_config_describe_carries_wire_tag():
    cfg32 = PlanConfig(rfft=True, n1=N1, n2=N2)
    cfg16 = PlanConfig(rfft=True, n1=N1, n2=N2, wire_dtype="bf16")
    assert "wire=" not in cfg32.describe()
    assert "wire=bf16" in cfg16.describe()
    assert cfg32.describe() != cfg16.describe()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_describe_is_the_reference_tag(name):
    knobs, ref_knobs = CONFIGS[name]
    assert PlanConfig(**knobs).describe() == _ref_describe(RefConfig(**ref_knobs))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_round_trips_through_json(name):
    cfg = PlanConfig(**CONFIGS[name][0])
    again = PlanConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert again == cfg and hash(again) == hash(cfg)
    assert again.describe() == cfg.describe()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_dict_rebuilds_the_port_config(name):
    knobs, ref_knobs = CONFIGS[name]
    d = json.loads(json.dumps(RefConfig(**ref_knobs).to_dict()))
    assert interop.plan_config_from_reference_dict(d) == PlanConfig(**knobs)


def test_hier_knobs_only_at_their_defaults():
    """The port has no hierarchical exchange: the reference's hier_axes and
    inter_wire_dtype are taken at their defaults and refused otherwise,
    naming the ROADMAP item that ports them."""
    base = PlanConfig(rfft=True).to_dict()
    ok = dict(base, hier_axes=None, inter_wire_dtype="fp32")
    assert PlanConfig.from_dict(ok) == PlanConfig(rfft=True)
    for bad in (dict(base, hier_axes=[2, 4]), dict(base, inter_wire_dtype="bf16")):
        with pytest.raises(ValueError, match="item 9 step 7"):
            PlanConfig.from_dict(bad)
    ref = RefConfig(rfft=True, n1=N1, n2=N2, hier_axes=(2, 4), axis_name=("host", "device"))
    with pytest.raises(ValueError, match="item 9 step 7"):
        interop.plan_config_from_reference_dict(json.loads(json.dumps(ref.to_dict())))


def test_execution_plan_config_round_trips():
    op = partial_gaussian_circulant(torch.Generator().manual_seed(0), 256, 128, device="cpu")
    pl = plan(op, prox=TVProx(shape=(16, 16)))
    assert PlanConfig.from_dict(pl.config.to_dict()) == pl.config
    assert pl.config.describe() == "n1xn2=auto rfft=off overlap=1 tail=plain prox=tv[16x16,it10]"


def test_mapmaking_plan_describe_matches_reference():
    """The map-making plan's tag on the reference's 16 x 16 problem: the TV
    prior on the sky's grid by default, no prox tag under l1."""
    import numpy as np

    from repro.core.mapmaking import build_mapmaking_plan as ref_plan
    from repro.core.mapmaking import build_mapmaking_problem as ref_build
    from repro.data.synthetic import extended_emission as ref_emission
    from repro_torch.core.mapmaking import build_mapmaking_plan

    ref = ref_build(jax.random.PRNGKey(11), ref_emission(jax.random.PRNGKey(7), 16, 16),
                    [0, 1, 16, 17], blur_order=1.0, sensing="romberg", blur_kind="gaussian")
    a, d = np.asarray, ref.deblur
    port = interop.mapmaking_problem_from_numpy(
        a(d.op.circ.col), a(d.op.circ.spec), a(d.op.omega), a(d.blur.col), a(d.blur.spec),
        a(d.y), a(d.image), a(ref.sky), ref.shifts, device="cpu")
    for prox in ("tv", None):
        got = build_mapmaking_plan(port, prox=prox).config.describe()
        assert got == _ref_describe(ref_plan(ref, prox=prox).config)
    assert "prox=tv[16x16,it10]" in build_mapmaking_plan(port).config.describe()
