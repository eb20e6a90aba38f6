"""Model configurations: the eight decoder-only architectures of the
reference's registry (``repro/configs``): four dense transformers, the MoE
moonshot-v1-16b-a3b and deepseek-v3-671b (MLA), the hybrid zamba2-1.2b and
xlstm-350m; full size and smoke size."""
