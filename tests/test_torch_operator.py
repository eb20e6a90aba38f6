"""The operator contract (``repro_torch.ops.operator``), ``DenseOperator``
and ``densify`` against the reference, and the local plan over the three
operator families (a mirror of ``tests/test_plan.py``'s local case).

Operators are built by the reference and handed across as numpy arrays.
Tolerance: 1e-5 relative to the largest reference magnitude (fp32 on both
sides); the dense matrices themselves are gathered, not computed, and must
be equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import densify as ref_densify
from repro.core.circulant import partial_gaussian_circulant as ref_pgc
from repro.core.circulant import partial_romberg_circulant as ref_prc
from repro_torch import interop
from repro_torch.core import Circulant, DenseOperator, PartialCirculant, densify
from repro_torch.ops.operator import GramInvertibleOperator, RecoveryOperator
from repro_torch.ops.plan import ExecutionPlan, plan

REL = 1e-5


def close(got, want, rel=REL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-30)
    assert err <= rel, f"norm-relative error {err:.3e} > {rel:.0e}"


def _ops(n, family, seed=0):
    """(reference partial circulant, port partial circulant)."""
    build = ref_pgc if family == "gaussian" else ref_prc
    kw = dict(normalize=True) if family == "gaussian" else {}
    op = build(jax.random.PRNGKey(seed), n, n // 2, **kw)
    port = interop.partial_circulant_from_numpy(np.asarray(op.circ.col),
                                                np.asarray(op.circ.spec),
                                                np.asarray(op.omega), device="cpu")
    return op, port


def _families(port):
    return {"partial": port, "circulant": port.circ, "dense": densify(port)}


@pytest.mark.parametrize("family", ["partial", "circulant", "dense"])
def test_operator_families_satisfy_the_protocols(family):
    _, port = _ops(64, "gaussian")
    op = _families(port)[family]
    assert isinstance(op, RecoveryOperator)
    # only the circulant families invert their gram matrix in the spectrum
    assert isinstance(op, GramInvertibleOperator) == (family != "dense")
    assert not isinstance(object(), RecoveryOperator)


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("family", ["gaussian", "romberg"])
def test_dense_operator_matches_reference(family, n, batch):
    ref, port = _ops(n, family, seed=n)
    ref_dense, dense = ref_densify(ref), densify(port)
    assert isinstance(dense, DenseOperator)
    assert dense.shape == ref_dense.shape == (n // 2, n)
    assert (dense.m, dense.n) == (ref_dense.m, ref_dense.n)
    np.testing.assert_array_equal(dense.to_dense().numpy(), np.asarray(ref_dense.to_dense()))
    rng = np.random.default_rng(n)
    x = rng.standard_normal(batch + (n,)).astype(np.float32)
    r = rng.standard_normal(batch + (n // 2,)).astype(np.float32)
    tx, tr = torch.from_numpy(x), torch.from_numpy(r)
    close(dense.matvec(tx), ref_dense.matvec(x))
    close(dense.rmatvec(tr), ref_dense.rmatvec(r))
    close(dense.operator_norm_bound(), ref_dense.operator_norm_bound())
    # the dense operator is the structured one, written out
    close(dense.matvec(tx), port.matvec(tx).numpy())
    close(dense.rmatvec(tr), port.rmatvec(tr).numpy())
    assert float(dense.operator_norm_bound()) >= float(port.operator_norm_bound()) * (1 - 1e-6)


@pytest.mark.parametrize("n", [64, 100])
def test_circulant_dense_rows_are_the_reference_matrix(n):
    """``to_dense`` gathers rows from the reversed doubled column: the
    reference's C[i, j] = col[(i - j) mod n], all rows and omega's rows."""
    ref, port = _ops(n, "gaussian", seed=7)
    np.testing.assert_array_equal(port.circ.to_dense().numpy(), np.asarray(ref.circ.to_dense()))
    np.testing.assert_array_equal(port.to_dense().numpy(), np.asarray(ref.to_dense()))
    rows = torch.tensor([0, n - 1, 3])
    np.testing.assert_array_equal(port.circ.dense_rows(rows).numpy(),
                                  np.asarray(ref.circ.to_dense())[[0, n - 1, 3]])


@pytest.mark.parametrize("family", ["partial", "circulant", "dense"])
def test_local_plan_reproduces_every_operator_bit_exactly(family):
    """Mirror of tests/test_plan.py::test_local_plan_reproduces_every_core_
    matvec_bit_exactly: the identity lowering, each family."""
    _, port = _ops(128, "gaussian", seed=3)
    op = _families(port)[family]
    pl = plan(op)
    assert isinstance(pl, ExecutionPlan) and not pl.is_distributed
    assert pl.operator is op and pl.tail == "plain"
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(128).astype(np.float32))
    assert torch.equal(pl.matvec(x), op.matvec(x))
    y = op.matvec(x)
    assert torch.equal(pl.rmatvec(y), op.rmatvec(y))


def test_dense_operator_is_a_plain_dataclass_on_its_device():
    mat = torch.arange(6.0).reshape(2, 3)
    op = DenseOperator(mat)
    assert op.to_dense() is mat and op.shape == (2, 3)
    assert isinstance(op.mat, torch.Tensor) and op.mat.device.type == "cpu"
    assert isinstance(PartialCirculant(Circulant.from_first_col(torch.ones(4)),
                                       torch.tensor([0, 2])), RecoveryOperator)
    with pytest.raises(Exception):
        op.mat = mat  # frozen
