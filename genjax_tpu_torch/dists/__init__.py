"""Distributions: the ``Distribution`` GFI, the catalog of 48, the
linear-Gaussian state-space posterior with its Kalman family, and the
discrete HMM's exact posterior with the dense-HMM tools."""

from . import catalog, special
from .catalog import *  # noqa: F401,F403  (the 48 distributions)
from .discrete_hmm import DiscreteHMM, DiscreteHMMConfiguration, forward_filtering_backward_sampling
from .hmm_tools import (
    HMMPosterior,
    forward_backward,
    forward_backward_parallel,
    forward_parallel,
    hmm_em,
    hmm_log_marginal,
    hmm_posterior_sample,
    viterbi,
    viterbi_parallel,
)
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
    "DiscreteHMM",
    "DiscreteHMMConfiguration",
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "HMMPosterior",
    "LGSSMParams",
    "LinearGaussianSSM",
    "LambdaDensity",
    "catalog",
    "exact_density",
    "ffbs",
    "forward_backward",
    "forward_backward_parallel",
    "forward_filtering_backward_sampling",
    "forward_parallel",
    "hmm_em",
    "hmm_log_marginal",
    "hmm_posterior_sample",
    "kalman_filter",
    "kalman_filter_parallel",
    "kalman_predict",
    "kalman_smoother",
    "kalman_smoother_parallel",
    "kalman_update",
    "lgssm_em",
    "special",
    "torch_distribution",
    "viterbi",
    "viterbi_parallel",
    *catalog.__all__,
]
