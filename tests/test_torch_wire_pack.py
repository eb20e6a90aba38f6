"""The port's wire pack/unpack, against the reference's ``repro.kernels.wire_pack``.

The plain versions (what a CPU tensor takes) are held *bit-exact* against
the reference's jnp oracle and its Pallas kernel in interpret mode, for the
three wire dtypes, on values that include infinities, fp16 overflow and
subnormals: both packages round to nearest even, so they put the same bits
on the wire.  The grouped layout the transpose all-to-all sends is held
against a per-chunk pack.  The Triton kernels run only on a card: the
``gpu`` test at the end holds them against the plain versions there, bit
for bit, and skips here.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.wire_pack.ops import WIRE_DTYPES, pack_wire, unpack_wire, wire_itemsize
from repro_torch.kernels.wire_pack.ref import pack_wire_ref, unpack_wire_ref

SHAPES = [(1000,), (3, 17, 33)]
# the reference's round-trip bounds (tests/test_wire_pack.py): bf16 keeps 8
# mantissa bits, fp16 11
ROUNDTRIP_RTOL = {"fp32": 0.0, "bf16": 2 ** -7, "fp16": 2 ** -10}
SPECIAL = [np.inf, -np.inf, 65520.0, -7e4, 1e30, 6e-6, -3e-7, 1e-40, -2.5e-39, 1e-9, 65504.0,
           0.0]


@pytest.fixture(scope="module")
def ref():
    """The reference package, loaded here (not at import) so the ``gpu`` test
    also runs on a card machine that has no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.wire_pack import ops as ref_ops
    from repro.kernels.wire_pack import ref as ref_ref

    return jnp, ref_ops, ref_ref


def _payload(shape, seed=0, special=True):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    if special:
        flat = z.view(np.float32).reshape(-1)
        flat[: len(SPECIAL)] = SPECIAL
    return z


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy, JAX or torch array of 2- or 4-byte floats."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("wire", sorted(WIRE_DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_pack_and_unpack_are_bit_equal_to_the_reference(wire, shape, ref):
    jnp, ref_ops, ref_ref = ref
    z = _payload(shape)
    got = pack_wire(torch.from_numpy(z), wire)
    assert got.shape == (2,) + shape and got.dtype == WIRE_DTYPES[wire]
    want_ref = ref_ref.pack_wire_ref(jnp.asarray(z), ref_ops.WIRE_DTYPES[wire])
    want_pallas = ref_ops.pack_wire(jnp.asarray(z), wire, substrate="pallas", interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want_ref))
    np.testing.assert_array_equal(_bits(got), _bits(want_pallas))
    # unpack: the same wire planes promote to the same complex64 bits
    back = _bits(torch.view_as_real(unpack_wire(got))).reshape(-1)
    want_back = ref_ops.unpack_wire(want_pallas, jnp.complex64, substrate="pallas",
                                    interpret=True)
    np.testing.assert_array_equal(back, _bits(np.asarray(want_back).view(np.float32)).reshape(-1))
    np.testing.assert_array_equal(
        back, _bits(np.asarray(ref_ref.unpack_wire_ref(want_ref)).view(np.float32)).reshape(-1))


def test_wire_dtypes_and_itemsizes_match_the_reference(ref):
    _, ref_ops, _ = ref
    assert sorted(WIRE_DTYPES) == sorted(ref_ops.WIRE_DTYPES)
    for wire in WIRE_DTYPES:
        assert wire_itemsize(wire) == ref_ops.wire_itemsize(wire)


@pytest.mark.parametrize("wire", sorted(WIRE_DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_roundtrip_within_the_reference_bound(wire, shape):
    z = torch.from_numpy(_payload(shape, seed=1, special=False))
    back = unpack_wire(pack_wire(z, wire))
    assert back.shape == z.shape and back.dtype == torch.complex64
    rel = float((back - z).norm() / z.norm())
    assert rel <= ROUNDTRIP_RTOL[wire], (wire, rel)


@pytest.mark.parametrize("wire", sorted(WIRE_DTYPES))
@pytest.mark.parametrize("groups,axis", [(2, -1), (4, -1), (3, -3), (2, -2)])
def test_grouped_layout_is_each_chunk_packed(wire, groups, axis):
    """pack_wire(groups=G, axis=a) lays out chunk g's planes as out[g], the
    layout all_to_all_single sends; unpack_wire(grouped) reassembles them."""
    shape = (6, 4, 8)
    z = torch.from_numpy(_payload(shape, seed=2))
    w = pack_wire(z, wire, groups=groups, axis=axis)
    chunks = torch.chunk(z, groups, dim=axis)
    assert w.shape == (groups, 2) + tuple(chunks[0].shape)
    for g, c in enumerate(chunks):
        assert torch.equal(_bits_t(w[g]), _bits_t(pack_wire(c.contiguous(), wire)))
    back = unpack_wire(w, grouped=True, axis=axis)
    assert torch.equal(back, unpack_wire(pack_wire(z, wire)))


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def test_wrappers_raise_on_bad_operands():
    with pytest.raises(ValueError, match="does not split"):
        pack_wire(torch.zeros(5, dtype=torch.complex64), "bf16", groups=2)
    with pytest.raises(ValueError, match="planes"):
        unpack_wire(torch.zeros(3, 4))
    with pytest.raises(KeyError):
        pack_wire(torch.zeros(4, dtype=torch.complex64), "int8")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("wire", sorted(WIRE_DTYPES))
def test_kernels_are_bit_equal_to_plain_versions_on_card(wire, cuda_device):
    pack_wire.launches = unpack_wire.launches = 0
    for shape, groups, axis in (((1000,), None, -1), ((3, 17, 33), None, -1),
                                ((2, 2, 6, 10), 2, -1), ((2, 2, 6, 10), 3, -2)):
        z = torch.from_numpy(_payload(shape)).to(cuda_device)
        got = pack_wire(z, wire, groups=groups, axis=axis)
        want = pack_wire_ref(z, wire, groups=groups, axis=axis)
        assert torch.equal(_bits_t(got), _bits_t(want)), (shape, groups)
        grouped = groups is not None
        back = unpack_wire(got, grouped=grouped, axis=axis)
        assert torch.equal(_bits_t(torch.view_as_real(back)),
                           _bits_t(torch.view_as_real(unpack_wire_ref(want, grouped=grouped,
                                                                      axis=axis))))
    torch.cuda.synchronize()
    assert pack_wire.launches == unpack_wire.launches == 4
    with pytest.raises(ValueError, match="complex64"):
        pack_wire(torch.zeros(8, 2, device=cuda_device).t(), wire)
