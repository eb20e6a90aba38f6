"""repro_torch.ops — spectral helpers, the priors and the plan layer."""

from .prox import (  # noqa: F401
    L1Prox,
    NonNegL1Prox,
    Prox,
    TVProx,
    WaveletProx,
    prox_from_dict,
    prox_to_dict,
)
