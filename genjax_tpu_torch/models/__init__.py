"""Models."""

from .gp import (
    gp_classify_laplace,
    gp_classify_predict,
    gp_log_marginal,
    gp_posterior,
    gp_regression,
    sq_exp_kernel,
)
from .regression import RegressionModel, hierarchical_regression, linear_regression
from .ssm import linear_gaussian_ssm, stochastic_volatility

__all__ = [
    "RegressionModel",
    "gp_classify_laplace",
    "gp_classify_predict",
    "gp_log_marginal",
    "gp_posterior",
    "gp_regression",
    "hierarchical_regression",
    "linear_gaussian_ssm",
    "linear_regression",
    "sq_exp_kernel",
    "stochastic_volatility",
]
