"""The seeded generators repeat, and the least-bytes count matches a hand count."""

import numpy as np
import pytest
import torch

from harness import gen as G
from harness import work

CFG6 = dict(problem="sec6", operator_seed=5, n=64, m=32, k=6, sensing="gaussian",
            normalize=True)
CFG7 = dict(problem="deblur", operator_seed=5, height=8, width=8, subsample=0.5,
            sensing="romberg", blur="moving-average", blur_order=5, star_density=0.1, blobs=3)


def _draw(seed):
    from harness.problems import deblur, sec6

    out = []
    for mod, cfg in ((sec6, CFG6), (deblur, CFG7)):
        col, omega = mod.operator(cfg, G.operator_stream(cfg, "cpu"))
        x = mod.signals(cfg, G.stream(seed, "data", "cpu"), 3)
        out += [col, omega, x, G.measure(col, omega, x)]
    out.append(torch.as_tensor(G.contract_mix(G.rng(seed, "contracts"), 8, [[1e-3, 3],
                                                                               [1e-6, 1]])))
    out.append(torch.as_tensor(G.arrival_times(G.rng(seed, "arrivals"), 8, 2.0)))
    return out


def test_one_seed_gives_one_set_of_inputs():
    for a, b in zip(_draw(2**31 + 11), _draw(2**31 + 11)):
        assert torch.equal(a, b)


def test_another_seed_changes_the_signals_not_the_operator():
    a, b = _draw(3), _draw(4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])  # the instrument
    assert not torch.equal(a[2], b[2])


def test_sparse_signals_have_k_nonzeros():
    x = G.sparse_signals(G.stream(1, "data", "cpu"), 5, 64, 6)
    assert (x != 0).sum(dim=1).tolist() == [6] * 5


def test_contract_mix_is_exact():
    tols = G.contract_mix(G.rng(9, "contracts"), 10, [[1e-3, 3], [1e-6, 1]])
    # shares 7.5 and 2.5: the floors 7 and 2, the tie for the last one to the first
    assert sorted(tols.tolist()) == [1e-6] * 2 + [1e-3] * 8


def test_arrivals_lie_in_the_window():
    t = G.arrival_times(G.rng(3, "arrivals"), 200, 4.0)
    assert len(t) == 200 and np.all(np.diff(t) >= 0) and t.min() >= 0 and t.max() < 4.0


def test_least_bytes_by_hand():
    # B = 2 signals of n = 8, m = 4 rows: v, z, mu, nu read and written
    # (8 arrays x 2 x 8 x 4 B = 512), y (2 x 4 x 4 B = 32), C's spectrum
    # (5 complex64 = 40)
    assert work.cpadmm_least_bytes(2, 8, 4) == 584
    assert work.least_ms(3.35e9) == pytest.approx(1.0)
