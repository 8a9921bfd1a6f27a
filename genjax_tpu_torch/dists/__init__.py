"""Distributions: the ``Distribution`` GFI, the catalog of 48, and the
linear-Gaussian state-space posterior with its Kalman family."""

from . import catalog, special
from .catalog import *  # noqa: F401,F403  (the 48 distributions)
from .lgssm import (
    LGSSMParams,
    LinearGaussianSSM,
    ffbs,
    kalman_filter,
    kalman_filter_parallel,
    kalman_predict,
    kalman_smoother,
    kalman_smoother_parallel,
    kalman_update,
    lgssm_em,
)
from .distribution import (
    Distribution,
    DistributionTrace,
    ExactDensity,
    LambdaDensity,
    exact_density,
    torch_distribution,
)

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "LGSSMParams",
    "LinearGaussianSSM",
    "LambdaDensity",
    "catalog",
    "exact_density",
    "ffbs",
    "kalman_filter",
    "kalman_filter_parallel",
    "kalman_predict",
    "kalman_smoother",
    "kalman_smoother_parallel",
    "kalman_update",
    "lgssm_em",
    "special",
    "torch_distribution",
    *catalog.__all__,
]
