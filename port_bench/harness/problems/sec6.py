"""Paper Sec. 6: k-sparse signals through a partial Gaussian circulant."""

from __future__ import annotations

from .. import gen as G

UNIT = "signals"


def operator(cfg: dict, gen):
    if cfg["sensing"] != "gaussian":
        raise ValueError(f"sec6 draws gaussian sensing; got {cfg['sensing']!r}")
    return G.gaussian_partial_circulant(gen, cfg["n"], cfg["m"], bool(cfg["normalize"]))


def signals(cfg: dict, gen, count: int):
    return G.sparse_signals(gen, count, cfg["n"], cfg["k"])
