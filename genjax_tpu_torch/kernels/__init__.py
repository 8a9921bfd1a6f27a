"""Column-layout kernels: the fused HMC sweep and its model bridge."""

from .bodies import Body, hier_regression, iid_normal
from .hmc import hmc_sweep, pallas_hmc
from .model_interface import ColumnPacker, column_hmc, column_logdensity

__all__ = [
    "Body",
    "ColumnPacker",
    "column_hmc",
    "column_logdensity",
    "hier_regression",
    "hmc_sweep",
    "iid_normal",
    "pallas_hmc",
]
