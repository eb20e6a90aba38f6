"""Launchers: the port's command-line entry points."""
