"""Paper Sec. 7: starfield frames through the joint circulant A = P (C B)."""

from __future__ import annotations

from .. import gen as G

UNIT = "frames"


def operator(cfg: dict, gen):
    n = cfg["height"] * cfg["width"]
    m = round(n * cfg["subsample"])
    if cfg["sensing"] != "romberg" or cfg["blur"] != "moving-average":
        raise ValueError(f"deblur draws romberg sensing and a moving-average blur; got "
                         f"{cfg['sensing']!r}, {cfg['blur']!r}")
    return G.romberg_blur_partial_circulant(gen, n, m, int(cfg["blur_order"]))


def signals(cfg: dict, gen, count: int):
    h, w = cfg["height"], cfg["width"]
    frames = G.starfields(gen, count, h, w, cfg["star_density"], cfg["blobs"])
    return frames.reshape(count, h * w)
