"""Distributions: the ``Distribution`` GFI, a catalog subset, and the
linear-Gaussian state-space posterior with its Kalman family."""

from .catalog import beta, categorical, flip, log_normal, mv_normal, mv_normal_diag, normal
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
)

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "LGSSMParams",
    "LinearGaussianSSM",
    "LambdaDensity",
    "beta",
    "categorical",
    "exact_density",
    "ffbs",
    "flip",
    "kalman_filter",
    "kalman_filter_parallel",
    "kalman_predict",
    "kalman_smoother",
    "kalman_smoother_parallel",
    "kalman_update",
    "lgssm_em",
    "log_normal",
    "mv_normal",
    "mv_normal_diag",
    "normal",
]
