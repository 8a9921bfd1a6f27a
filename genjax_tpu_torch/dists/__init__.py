"""Distributions: the ``Distribution`` GFI and a catalog subset."""

from .catalog import beta, categorical, flip, log_normal, mv_normal, mv_normal_diag, normal
from .distribution import (
    Distribution,
    DistributionTrace,
    ExactDensity,
    LambdaDensity,
    exact_density,
)

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "LambdaDensity",
    "beta",
    "categorical",
    "exact_density",
    "flip",
    "log_normal",
    "mv_normal",
    "mv_normal_diag",
    "normal",
]
