"""Inference library: MCMC runners, the moves they run as edit requests, the
one-call drivers ``sample_posterior`` and ``sample_logdensity`` and their
convergence diagnostics."""

from . import adaptation, diagnostics, mcmc, requests, sample
from .diagnostics import ess, split_rhat
from .mcmc import MHChainResult, mh, run_chain, run_chains, run_chains_hmc, run_chains_nuts
from .sample import LogdensitySamples, PosteriorSamples, sample_logdensity, sample_posterior

__all__ = [
    "LogdensitySamples",
    "MHChainResult",
    "PosteriorSamples",
    "adaptation",
    "diagnostics",
    "ess",
    "mcmc",
    "mh",
    "requests",
    "run_chain",
    "run_chains",
    "run_chains_hmc",
    "run_chains_nuts",
    "sample",
    "sample_logdensity",
    "sample_posterior",
    "split_rhat",
]
