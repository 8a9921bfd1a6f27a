"""Models."""

from .bnn import bayesian_nn, bnn_exact_linear_posterior, bnn_predict
from .gp import (
    gp_classify_laplace,
    gp_classify_predict,
    gp_log_marginal,
    gp_posterior,
    gp_regression,
    sq_exp_kernel,
)
from .hmm import dense_hmm_model, discrete_hmm_model
from .mixture import dp_mixture_model, gaussian_mixture_model
from .ppca import ppca_em, ppca_log_likelihood, ppca_ml, ppca_model, ppca_posterior
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
    "bayesian_nn",
    "bnn_exact_linear_posterior",
    "bnn_predict",
    "dense_hmm_model",
    "discrete_hmm_model",
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
    "ppca_em",
    "ppca_log_likelihood",
    "ppca_ml",
    "ppca_model",
    "ppca_posterior",
    "sq_exp_kernel",
    "stochastic_volatility",
]
