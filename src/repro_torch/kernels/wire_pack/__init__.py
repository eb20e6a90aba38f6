"""Wire pack/unpack: complex payloads <-> split-complex wire-dtype planes."""
