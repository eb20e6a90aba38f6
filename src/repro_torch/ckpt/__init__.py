"""Checkpoint/restart of solver state (port of ``repro/ckpt``)."""
