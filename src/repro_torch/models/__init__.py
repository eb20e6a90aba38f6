"""The decoder-only LM: config, layers, GQA and MLA attention, the MoE FFN,
the Mamba-2 and xLSTM blocks, the layer stack, the loss and its train /
eval / prefill / decode entry points (port of ``repro/models``)."""
