"""Inference library: MCMC runners, the moves they run as edit requests, the
one-call driver ``sample_posterior`` and its convergence diagnostics."""

from . import adaptation, diagnostics, mcmc, requests, sample
from .diagnostics import ess, split_rhat
from .mcmc import MHChainResult, mh, run_chain, run_chains, run_chains_hmc, run_chains_nuts
from .sample import PosteriorSamples, sample_logdensity, sample_posterior

__all__ = [
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
