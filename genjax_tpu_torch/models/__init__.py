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

__all__ = [
    "RegressionModel",
    "gp_classify_laplace",
    "gp_classify_predict",
    "gp_log_marginal",
    "gp_posterior",
    "gp_regression",
    "hierarchical_regression",
    "linear_regression",
    "sq_exp_kernel",
]
