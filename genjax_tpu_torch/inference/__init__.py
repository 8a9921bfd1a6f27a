"""Inference library: MCMC runners and the moves they run as edit requests."""

from . import mcmc, requests
from .mcmc import MHChainResult, mh, run_chain, run_chains, run_chains_hmc

__all__ = [
    "MHChainResult",
    "mcmc",
    "mh",
    "requests",
    "run_chain",
    "run_chains",
    "run_chains_hmc",
]
