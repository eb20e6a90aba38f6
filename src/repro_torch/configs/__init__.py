"""Model configurations: the four dense decoder-only architectures of the
reference's registry (``repro/configs``), full size and smoke size."""
