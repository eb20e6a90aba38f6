"""repro_torch.ops — spectral helpers, the l1 prior and the local plan layer."""
