"""Entries: how a traffic mix drives the program.

A traffic file names its entry under ``entry``; the harness loads
``harness.entries.<entry>`` and calls its ``run(ctx)``, which builds the
program's objects, draws the work, warms up, measures the window and
returns a :class:`harness.record.Record`.
"""
