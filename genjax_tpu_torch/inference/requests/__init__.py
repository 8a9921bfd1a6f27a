"""MCMC moves as edit requests."""

from .hmc import HMC, SafeHMC, mh_accept, selection_gradient

__all__ = ["HMC", "SafeHMC", "mh_accept", "selection_gradient"]
