"""MCMC moves as edit requests."""

from .elliptical import EllipticalSlice
from .hmc import HMC, SafeHMC, mh_accept, selection_gradient
from .mala import MALA
from .nuts import NUTS
from .rejuvenate import Rejuvenate
from .slice_ import SliceSample

__all__ = ["EllipticalSlice", "HMC", "MALA", "NUTS", "Rejuvenate", "SafeHMC", "SliceSample", "mh_accept", "selection_gradient"]
