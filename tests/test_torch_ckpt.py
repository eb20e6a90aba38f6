"""Checkpointing of the port, against its reference ``repro/ckpt/checkpoint.py``.

The first nine cases mirror ``tests/test_checkpoint.py`` on torch trees.
Then checkpoints cross between the packages both ways (one npz format),
and a whole checkpointed CPISTA solve on the kernel tail, interrupted after
its first chunk and resumed from the port's checkpoint, is held against the
reference's uninterrupted run at the reference's 1e-5 relative contract.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.core import RecoveryProblem as RefProblem
from repro.core import solve_checkpointed as ref_solve_checkpointed
from repro.core.circulant import partial_gaussian_circulant as ref_pgc
from repro.core.ista import IstaState as RefIstaState
from repro.data.synthetic import paper_regime as ref_regime
from repro.data.synthetic import sparse_signal as ref_sparse
from repro_torch import interop
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.ista import IstaState
from repro_torch.core.solvers import RecoveryProblem, make_stepper, solve_checkpointed
from repro_torch.ops.plan import plan


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(4, 3, generator=g),
        "nested": {"b": torch.arange(5), "c": [torch.ones(2), torch.zeros((2, 2))]},
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt._leaf_paths(tree)]


def _assert_trees_equal(got, want):
    assert type(got) is type(want)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g, w)


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 7, tree)
    step, restored = ckpt.restore(str(tmp_path), None, tree)
    assert step == 7
    _assert_trees_equal(restored, tree)
    assert isinstance(restored["nested"]["c"], list)


def test_latest_and_retention(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 3  # pruned to the newest 3


def test_corruption_detected(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 1, tree)
    arrs = os.path.join(path, "arrays.npz")
    data = bytearray(open(arrs, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(arrs, "wb").write(bytes(data))
    with pytest.raises(Exception):
        ckpt.restore(str(tmp_path), 1, tree)


def test_atomic_publish_no_partial_dirs(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    names = os.listdir(tmp_path)
    assert all(not n.startswith(".tmp") for n in names), names


def test_restore_specific_step(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    ckpt.save(str(tmp_path), 1, t1)
    ckpt.save(str(tmp_path), 2, t2)
    step, restored = ckpt.restore(str(tmp_path), 1, t1)
    assert step == 1
    assert torch.equal(restored["a"], t1["a"]) and not torch.equal(restored["a"], t2["a"])


def _unpad(ckpt_dir, step):
    """Rename a saved step dir to the unpadded legacy name (step_9)."""
    os.rename(os.path.join(ckpt_dir, f"step_{step:010d}"), os.path.join(ckpt_dir, f"step_{step}"))


def test_unpadded_step_names_order_numerically(tmp_path):
    tree = _tree()
    for s in (9, 10, 100):
        ckpt.save(str(tmp_path), s, tree, keep=100)
        _unpad(str(tmp_path), s)
    assert ckpt.latest_step(str(tmp_path)) == 100
    step, _ = ckpt.restore(str(tmp_path), None, tree)
    assert step == 100
    step, _ = ckpt.restore(str(tmp_path), 9, tree)  # an unpadded dir by number
    assert step == 9


def test_prune_keeps_numerically_newest_across_paddings(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 9, tree, keep=100)
    _unpad(str(tmp_path), 9)
    ckpt.save(str(tmp_path), 10, tree, keep=1)
    names = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert names == ["step_0000000010"], names
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_prune_never_touches_step_being_published(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 100, tree, keep=1)
    path5 = ckpt.save(str(tmp_path), 5, tree, keep=1)
    assert os.path.isdir(path5), "just-published step_5 was pruned"
    step, _ = ckpt.restore(str(tmp_path), 5, tree)
    assert step == 5


def test_non_numeric_step_dirs_are_ignored(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree)
    os.makedirs(os.path.join(tmp_path, "step_backup"))
    assert ckpt.latest_step(str(tmp_path)) == 3
    ckpt.save(str(tmp_path), 4, tree, keep=1)  # prune must not crash on it
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_restore_places_leaves_on_the_requested_device(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree)
    like = {"a": torch.empty(0, device="meta"),
            "nested": {"b": 0, "c": [torch.empty(0, device="meta")] * 2}}
    _, on_like = ckpt.restore(str(tmp_path), 1, like)
    assert on_like["a"].device.type == "meta" and on_like["nested"]["b"].device.type == "cpu"
    _, on_cpu = ckpt.restore(str(tmp_path), 1, like, device="cpu")
    _assert_trees_equal(on_cpu, tree)


# ---------------------------------------------------------------------------
# across the packages: one npz format, keyed by NamedTuple field names
# ---------------------------------------------------------------------------


def _ref_ista_state():
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    return RefIstaState(x=jax.random.normal(k1, (2, 64)), x_prev=jax.random.normal(k2, (2, 64)),
                        t_mom=jnp.array([1.5, 2.5], jnp.float32))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _ref_ista_state()
    ref_ckpt.save(str(tmp_path), 40, state)
    like = IstaState(*(torch.zeros(a.shape) for a in state))
    step, got = ckpt.restore(str(tmp_path), None, like)
    assert step == 40 and isinstance(got, IstaState)
    for g, w in zip(got, state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.float32


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = IstaState(*(torch.from_numpy(np.array(a)) for a in _ref_ista_state()))
    ckpt.save(str(tmp_path), 40, state)
    like = jax.eval_shape(_ref_ista_state)
    step, got = ref_ckpt.restore(str(tmp_path), None, like)
    assert step == 40 and type(got).__name__ == "IstaState"
    for g, w in zip(got, state):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    # and a nested dict / list tree
    tree = _tree()
    ckpt.save(str(tmp_path / "tree"), 1, tree)
    _, ref_tree = ref_ckpt.restore(str(tmp_path / "tree"), None,
                                   jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree))
    for g, w in zip(jax.tree.leaves(ref_tree), _leaves(tree)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


# ---------------------------------------------------------------------------
# the slice as a whole: interrupted CPISTA on the kernel tail, resumed
# ---------------------------------------------------------------------------


class _Preempted(Exception):
    pass


def test_interrupted_kernel_cpista_resumes_to_the_reference_result(tmp_path):
    n, iters, chunk = 1024, 60, 20
    m, k = ref_regime(n)
    x = ref_sparse(jax.random.PRNGKey(20), n, k, batch=(2,))
    op = ref_pgc(jax.random.PRNGKey(21), n, m, normalize=True)
    ref = RefProblem(op=op, y=op.matvec(x), x_true=x)
    x_ref, mse_ref = ref_solve_checkpointed(ref, "ista", iters=iters, chunk=chunk, alpha=1e-4)

    port_op = interop.partial_circulant_from_numpy(
        np.asarray(op.circ.col), np.asarray(op.circ.spec), np.asarray(op.omega), device="cpu")
    port = RecoveryProblem(port_op, torch.from_numpy(np.array(ref.y)),
                           torch.from_numpy(np.array(x)))
    pl = plan(port_op, tail="kernel")
    save = ckpt.solver_checkpoint_cb(str(tmp_path))

    def save_then_preempt(step, state):
        save(step, state)
        raise _Preempted

    with pytest.raises(_Preempted):
        solve_checkpointed(port, "ista", iters=iters, chunk=chunk, alpha=1e-4,
                           save_cb=save_then_preempt, plan=pl)
    like = make_stepper(port, "ista", alpha=1e-4, plan=pl).init()
    restore = ckpt.restore(str(tmp_path), None, like)
    assert restore[0] == chunk
    x_hat, mse = solve_checkpointed(port, "ista", iters=iters, chunk=chunk, alpha=1e-4,
                                    save_cb=save, restore=restore, plan=pl)
    assert ckpt.latest_step(str(tmp_path)) == iters
    err = np.linalg.norm(x_hat.numpy() - np.asarray(x_ref)) / np.linalg.norm(np.asarray(x_ref))
    assert err <= 1e-5
    np.testing.assert_allclose(mse.numpy(), np.asarray(mse_ref), rtol=1e-4)
