"""The decoder-only LM: config, layers, GQA attention, the MoE FFN, the
layer stack, the loss and its train / eval / prefill / decode entry points
(port of ``repro/models``)."""
