"""MCMC moves as edit requests."""

from .hmc import HMC, SafeHMC, mh_accept, selection_gradient
from .nuts import NUTS

__all__ = ["HMC", "NUTS", "SafeHMC", "mh_accept", "selection_gradient"]
