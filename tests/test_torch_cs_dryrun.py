"""The cost walk and the CS dry run (``repro_torch.launch.{cost_walk,
cs_dryrun}``) against the reference's HLO walk and ``cs_dryrun``.

* CS collective bytes: each of the five ``VARIANTS`` at (64, 64), batch 4,
  2 iterations on a (2, 4) mesh, and both multi-host forms on data 2 x host
  2 x device 2, send per rank exactly the reference's all-to-all and
  ``collective-permute`` bytes, in as many collectives.  The walk's flops
  are held to the reference's only within a band: the reference counts
  elementwise operations by their output sizes and the port counts matrix
  products, attention and FFTs (ratio printed).
* The walk itself: a ``meta`` block walks exactly as the same block on the
  CPU; the ``c10d`` count of a CS block's exchange equals the bytes
  ``dist.fft.WIRE_BYTES`` saw; an all-reduce, all-gather and all-to-all are
  each counted once under the reference's names; closed forms as in
  ``tests/test_hlo_analysis.py``; the tuner's model unchanged by
  ``WIRE_MULT``.
* The ``meta`` route of the nine kernel wrappers: one reported launch with
  the kernel's bytes and flops, ``meta`` results, nothing computed and no
  count; CPU tensors still take the plain version.  The ``gpu`` tests hold
  a ``meta`` report against the CUDA launch's.

Every fake world and every reference run on 8 placeholder devices runs in
a subprocess (``torch_dryrun_programs.py``).
"""

import dataclasses
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.banded_conv.ops import blur_apply
from repro_torch.kernels.circulant_matvec.ops import circulant_matvec_direct
from repro_torch.kernels.cpadmm_tail.ops import fused_cpadmm_tail
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.soft_threshold.ops import fused_admm_update, fused_ista_update
from repro_torch.kernels.spectral_pointwise.ops import spectral_update
from repro_torch.kernels.wire_pack.ops import pack_wire, unpack_wire
from repro_torch.launch import cost_walk, roofline
from torch_dryrun_programs import CS_VARIANTS, MH_FORMS, start

CS = dict(n1=64, n2=64, batch=4, iters=2)
FLOP_BAND = (0.3, 1.2)  # port / reference walked flops of a CS block


@pytest.fixture(scope="module")
def cs_programs():
    """The port's CS walks and the reference's, started together."""
    started = {"port": start("port_cs", **CS), "walks": start("port_walks", n1=32, n2=32,
                                                               batch=2, iters=2),
               "collectives": start("port_collectives")}
    try:
        import jax  # noqa: F401

        started["ref"] = start("ref_cs", **CS)
    except ImportError:
        pass
    yield started
    for s in started.values():
        s.proc.kill()
        s.proc.communicate()


@pytest.mark.parametrize("tag", CS_VARIANTS + tuple(t for t, *_ in MH_FORMS))
def test_cs_collective_bytes_equal_the_references(cs_programs, tag):
    if "ref" not in cs_programs:
        pytest.skip("jax is not installed")
    got, want = cs_programs["port"].result()[tag], cs_programs["ref"].result()[tag]
    assert got["collective_bytes"] == want["collective_bytes"]
    assert got["collective_counts"] == want["collective_counts"]
    ratio = got["flops"] / want["flops"]
    print(f"{tag}: walked flops port / reference = {ratio:.3f}")
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


def test_cs_variants_take_the_cards_kernels(cs_programs):
    """The blocks resolve to the card's kernel tail on ``meta``: one
    ``cpadmm_tail`` launch an iteration, a wire pack and unpack a chunk
    exchange on the bf16 wire."""
    got = cs_programs["port"].result()
    for tag in CS_VARIANTS:
        assert got[tag]["kernel_launches"]["cpadmm_tail"] == CS["iters"], tag
    a2a = got["wire_bf16"]["collective_counts"]["all-to-all"]
    assert got["wire_bf16"]["kernel_launches"]["pack_wire"] == a2a
    assert got["wire_bf16"]["kernel_launches"]["unpack_wire"] == a2a


def test_multipod_default_batch_raises_as_the_reference(cs_programs):
    """The reference's ``cs_dryrun --multipod`` at its default batch of 16
    raises in ``shard_map`` (16 signals over the 32 (pod, data) ranks); the
    port raises ``ValueError`` there too."""
    got = cs_programs["port"].result()["multipod_16"]
    assert got.startswith("ValueError") and "32" in got


@pytest.mark.parametrize("wire", ["fp32", "bf16"])
def test_meta_walk_equals_the_cpu_walk(cs_programs, wire):
    """A block on ``meta`` (fake world of one) walks exactly as the same
    block on the CPU (gloo world of one), plain tail: at fp32 wires every
    number; at bf16 the ``meta`` block takes the card's wire kernels where
    the CPU runs their plain versions, so all but the launches, bytes and
    kernels heard."""
    walks = cs_programs["walks"].result()
    cpu, meta = walks[f"cpu/{wire}"], walks[f"meta/{wire}"]
    keys = ("flops", "collective_bytes", "collective_counts", "wire")
    if wire == "fp32":
        keys += ("bytes", "launches", "kernel_launches")
    for key in keys:
        assert meta[key] == cpu[key], key
    assert meta["collective_bytes"]["all-to-all"] > 0


@pytest.mark.parametrize("side", ["cpu/fp32", "cpu/bf16", "meta/bf16", "meta-kernel/bf16"])
def test_c10d_count_equals_the_exchanges_wire_bytes(cs_programs, side):
    """The four-step exchange's bytes, counted from the ``c10d`` ops, are
    the bytes ``dist.fft.WIRE_BYTES`` counted (nothing twice)."""
    w = cs_programs["walks"].result()[side]
    assert w["collective_bytes"] == {"all-to-all": float(w["wire"]["flat"])}
    assert w["wire"]["intra"] == w["wire"]["inter"] == 0


def test_each_collective_counted_once_under_its_name(cs_programs):
    """One bf16 (8, 16) payload over a group of 4: an all-reduce counts its
    256 bytes, an all-gather its 4 x 256 result, an all-to-all its 256; once
    each, by the group's global ranks, with no launch and no HBM bytes."""
    got = cs_programs["collectives"].result()
    for name, nbytes in (("all-reduce", 256.0), ("all-gather", 1024.0), ("all-to-all", 256.0)):
        assert got[name]["collective_bytes"] == {name: nbytes}
        assert got[name]["collective_counts"] == {name: 1.0}
        assert got[name]["launches"] == 0 and got[name]["bytes"] == 0.0
        assert got[name]["groups"] == [[0, 1, 2, 3]]


def test_wire_mult_leaves_the_tuners_costs_unchanged():
    """The tuner's walks hold all-to-alls and hops only, multiplier 1: its
    model gives what it gave before ``WIRE_MULT``; an all-reduce counts twice."""
    c = cost_walk.Cost(flops=1e9, bytes=1e6,
                       collective_bytes={"all-to-all": 3e8, "collective-permute": 1e8})
    t = roofline.model_block_times(c, 4, dcn_bytes=1e8)
    assert t["collective_s"] == pytest.approx(3e8 / roofline.NVLINK_BW
                                              + 1e8 / roofline.INTER_HOST_BW, rel=1e-15)
    r = roofline.model_block_times(dataclasses.replace(c, collective_bytes={"all-reduce": 1e8}))
    assert r["collective_s"] == pytest.approx(2e8 / roofline.NVLINK_BW)


# ---------------------------------------------------------------------------
# closed forms (the mirrors of tests/test_hlo_analysis.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_single_matmul_flops_exact(device):
    a, b = torch.empty(128, 64, device=device), torch.empty(64, 32, device=device)
    assert cost_walk.walk(torch.mm, a, b).flops == 2 * 128 * 64 * 32


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_loop_of_twelve_products_counts_twelve(device):
    x, ws = torch.empty(64, 64, device=device), torch.empty(12, 64, 64, device=device)

    def loop(x, ws):
        for w in ws:
            x = x @ w
        return x

    c = cost_walk.walk(loop, x, ws)
    assert c.flops == 12 * 2 * 64**3 and c.launches == 12


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_fft_flops_5nlogn(device):
    v = torch.empty(8192, dtype=torch.complex64, device=device)
    assert cost_walk.walk(torch.fft.fft, v).flops == pytest.approx(5 * 8192 * math.log2(8192))


def test_slice_does_not_charge_source():
    a = torch.empty(4096, 4096, device="meta")
    c = cost_walk.walk(lambda a: a[7:8] * 2.0, a)
    assert c.bytes == 2 * 4096 * 4


def test_peak_bytes_follow_the_live_tensors():
    """Three 4 KiB temporaries alive at once, then freed, then one more:
    the peak is the three, and the operands count nothing."""
    x = torch.empty(1024, device="meta")

    def fn(x):
        a, b, c = x * 2, x * 3, x * 4
        s = a + b + c  # (a + b) is a fourth buffer, s a fifth
        del a, b, c
        return s * 2

    assert cost_walk.walk(fn, x).peak_bytes == 5 * 4096


# ---------------------------------------------------------------------------
# the meta route of the nine wrappers
# ---------------------------------------------------------------------------


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _c(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


B, N, NF = 3, 256, 129
# wrapper call on given operands -> (kernel reported, result shapes, bytes, flops)
CASES = {
    "spectral_pointwise": (
        lambda t: spectral_update(t((NF,), torch.complex64), t((NF,)), t((B, NF), torch.complex64),
                                  t((B, NF), torch.complex64), 0.1, 0.1),
        "spectral_pointwise", 8 * NF + 4 * NF + 3 * 8 * B * NF, 12 * B * NF),
    "cpadmm_tail": (
        lambda t: fused_cpadmm_tail(t((B, N)), t((B, N)), t((N,)), t((N,)), t((B, N)), t((B, N)),
                                    0.01, 0.1, 1.0, 1.0),
        "cpadmm_tail", 4 * (2 * N + 8 * B * N), 12 * B * N),
    "soft_threshold_ista": (
        lambda t: fused_ista_update(t((B, N)), t((B, N)), 0.05, tau=0.9),
        "soft_threshold_ista", 12 * B * N, 4 * B * N),
    "soft_threshold_admm": (
        lambda t: fused_admm_update(t((B, N)), t((B, N)), 0.05, 1.0),
        "soft_threshold_admm", 16 * B * N, 6 * B * N),
    "circulant_matvec": (
        lambda t: circulant_matvec_direct(t((N,)), t((B, N))),
        "circulant_matvec", 4 * N + 8 * B * N, 6 * B * N * N),
    "banded_conv": (
        lambda t: blur_apply(t((5,)), t((B, N)), order=5),
        "banded_conv", 4 * 5 + 8 * B * N, 2 * 5 * B * N),
    "pack_wire": (
        lambda t: pack_wire(t((4, 8), torch.complex64), "bf16", groups=4, axis=0),
        "pack_wire", 8 * 32 + 2 * 2 * 32, 0),
    "unpack_wire": (
        lambda t: unpack_wire(t((4, 2, 1, 8), torch.bfloat16), grouped=True, axis=0),
        "unpack_wire", 2 * 2 * 32 + 8 * 32, 0),
    "flash_attention_sm90": (
        lambda t: flash_ops.flash_attention(*(t((2, 64, 4, 128), torch.bfloat16),
                                              t((2, 64, 2, 128), torch.bfloat16),
                                              t((2, 64, 2, 128), torch.bfloat16))),
        "flash_attention_sm90", 2 * (2 * 2 * 64 * 4 * 128 + 2 * 2 * 64 * 2 * 128),
        4 * 2 * 4 * 64 * 64 * 128 / 2),
    "flash_attention_mma": (
        lambda t: flash_ops.flash_attention(t((1, 16, 2, 32)), t((1, 24, 1, 32)),
                                            t((1, 24, 1, 32)), causal=False),
        "flash_attention_mma", 4 * (2 * 16 * 2 * 32 + 2 * 24 * 32), 4 * 2 * 16 * 24 * 32),
}
COUNTERS = {"spectral_pointwise": spectral_update, "cpadmm_tail": fused_cpadmm_tail,
            "soft_threshold_ista": fused_ista_update, "soft_threshold_admm": fused_admm_update,
            "circulant_matvec": circulant_matvec_direct, "banded_conv": blur_apply,
            "pack_wire": pack_wire, "unpack_wire": unpack_wire,
            "flash_attention_sm90": flash_ops.flash_attention_sm90,
            "flash_attention_mma": flash_ops.flash_attention_mma}


def _shaped(device):
    """Operands made with ``empty``, which the walk counts as no launch."""
    return lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("name", list(CASES))
def test_meta_route_reports_the_kernels_launch(name):
    call, kernel, nbytes, flops = CASES[name]
    counter = COUNTERS[name]
    before = counter.launches
    plain = call(lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype))
    # (the plain version on the CPU: no report without a walk, no count)
    holder = {}
    cost = cost_walk.walk(lambda: holder.setdefault("out", call(_shaped("meta"))))
    assert cost.kernel_launches == {kernel: 1} and cost.launches == 1
    assert cost.bytes == nbytes and cost.flops == flops
    assert counter.launches == before  # a dry run launches nothing
    got = holder["out"]
    outs = (got,) if isinstance(got, torch.Tensor) else got
    wants = (plain,) if isinstance(plain, torch.Tensor) else plain
    for o, w in zip(outs, wants, strict=True):
        assert o.device.type == "meta" and o.shape == w.shape and o.dtype == w.dtype


def test_meta_route_makes_the_cards_checks():
    with pytest.raises(ValueError, match="float32"):
        fused_cpadmm_tail(*(_m(B, N, dtype=torch.float64),) * 2, _m(N), _m(N),
                          *(_m(B, N),) * 2, 0.01, 0.1, 1.0, 1.0)
    with pytest.raises(ValueError, match="D in"):
        flash_ops.flash_attention(*(_m(1, 8, 1, 24),) * 3)
    with pytest.raises(ValueError, match="n % 128"):
        circulant_matvec_direct(_m(100), _m(2, 100))
    with pytest.raises(ValueError, match="different devices|CUDA"):
        spectral_update(_m(NF, dtype=torch.complex64), _c(NF),
                        _m(B, NF, dtype=torch.complex64), _m(B, NF, dtype=torch.complex64),
                        0.1, 0.1)
    assert kernels._launch_hook is None


# ---------------------------------------------------------------------------
# on the card: a meta report against the CUDA launch's
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cpadmm_tail", "pack_wire", "flash_attention_sm90"])
def test_meta_report_equals_the_cuda_launch(cuda_device, name):
    call, kernel, nbytes, flops = CASES[name]
    call(_shaped(cuda_device))  # the build and JIT, outside the walks
    card = cost_walk.walk(lambda: call(_shaped(cuda_device)))
    meta = cost_walk.walk(lambda: call(_shaped("meta")))
    for c in (card, meta):
        assert c.kernel_launches == {kernel: 1}
        assert (c.bytes, c.flops, c.launches) == (nbytes, flops, 1)


def test_the_fake_process_group_is_where_the_dry_run_takes_it():
    """``init_dry_run`` leans on a private torch path (the card machine runs
    another torch than this one): its store and the fake backend's
    registration, imported here without joining any group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert issubclass(FakeStore, dist.Store)
    assert "fake" in dist.Backend.backend_list
    assert not dist.is_initialized()
