"""Deployment kinds: each module draws one kind's operator and signals.

A configuration file names its kind under ``problem``; the harness loads
``harness.problems.<problem>``, which provides ``operator(cfg, gen)`` ->
(float32 first column, int64 row set) and ``signals(cfg, gen, count)`` ->
(count, n) float64 ground truths, both drawn on the generator's device,
and ``UNIT``, what a rate of its signals counts (frames, signals).
"""
