"""Core paper contribution: circulant operators + the LASSO solver family."""

from .circulant import (  # noqa: F401
    Circulant,
    DenseOperator,
    PartialCirculant,
    airy_blur,
    compose_sensing_blur,
    densify,
    gaussian_blur,
    gaussian_circulant,
    moving_average_blur,
    partial_gaussian_circulant,
    partial_romberg_circulant,
    random_omega,
    romberg_circulant,
    shift_circulant,
)
from .soft_threshold import soft_threshold  # noqa: F401
from .solvers import (  # noqa: F401
    PAPER_TARGET_MSE,
    RecoveryProblem,
    Trace,
    make_stepper,
    solve,
    solve_checkpointed,
    solve_until,
)
