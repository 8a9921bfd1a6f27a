"""MCMC moves as edit requests."""

from .hmc import HMC, SafeHMC, mh_accept, selection_gradient
from .mala import MALA
from .nuts import NUTS
from .rejuvenate import Rejuvenate

__all__ = ["HMC", "MALA", "NUTS", "Rejuvenate", "SafeHMC", "mh_accept", "selection_gradient"]
