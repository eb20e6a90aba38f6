"""The port's benchmark harness (see ``port_bench/run.py``).

Driven by data: a cell of ``BENCHMARK.json`` names a configuration file
(``configs/``, whose ``problem`` picks ``harness.problems.<problem>``), a
traffic file (``traffic/<traffic>.json``, whose ``entry`` picks
``harness.entries.<entry>``) and its limits (``limits/<workload>.json``);
each metric is read by ``metrics/<name>.py``.  Imports nothing of JAX, of
the JAX package or of ``benchmarks/``; the program (``repro_torch``) is
imported only by ``harness.port`` and the entries.
"""
