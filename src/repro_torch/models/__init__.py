"""The dense decoder-only LM: config, layers, GQA attention, the layer
stack and its prefill / decode entry points (port of ``repro/models``)."""
