"""Deterministic synthetic data for the port (sparse signals, starfields)."""
