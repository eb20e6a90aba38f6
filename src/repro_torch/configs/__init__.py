"""Model configurations: the four dense decoder-only architectures of the
reference's registry (``repro/configs``) and its MoE moonshot-v1-16b-a3b,
full size and smoke size."""
