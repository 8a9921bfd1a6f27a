"""Models."""

from .gp import (
    gp_classify_laplace,
    gp_classify_predict,
    gp_log_marginal,
    gp_posterior,
    gp_regression,
    sq_exp_kernel,
)
from .mixture import dp_mixture_model, gaussian_mixture_model
from .regression import (
    RegressionModel,
    hierarchical_regression,
    linear_regression,
    logistic_regression,
    poisson_regression,
)
from .ssm import linear_gaussian_ssm, stochastic_volatility

__all__ = [
    "RegressionModel",
    "dp_mixture_model",
    "gaussian_mixture_model",
    "gp_classify_laplace",
    "gp_classify_predict",
    "gp_log_marginal",
    "gp_posterior",
    "gp_regression",
    "hierarchical_regression",
    "linear_gaussian_ssm",
    "linear_regression",
    "logistic_regression",
    "poisson_regression",
    "sq_exp_kernel",
    "stochastic_volatility",
]
