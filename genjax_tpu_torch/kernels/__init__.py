"""Column-layout kernels: the fused HMC, NUTS and Gaussian elliptical-slice
sweeps, the generic elliptical slice sampler, the warmups and the model
bridge."""

from .bodies import Body, hier_regression, iid_normal
from .elliptical import (
    ess_gauss_sweep,
    ess_sweep_cols,
    ess_sweep_gauss_cols,
    ess_sweep_gauss_pallas,
    ess_transition_cols,
    ess_transition_gauss_cols,
)
from .hmc import hmc_sweep, pallas_hmc, warmup_column
from .model_interface import ColumnPacker, column_hmc, column_logdensity, column_nuts
from .nuts import nuts_sweep_cols, nuts_transition, nuts_transition_cols
from .nuts_pallas import nuts_sweep, pallas_nuts, warmup_column_nuts

__all__ = [
    "Body",
    "ColumnPacker",
    "column_hmc",
    "column_logdensity",
    "column_nuts",
    "ess_gauss_sweep",
    "ess_sweep_cols",
    "ess_sweep_gauss_cols",
    "ess_sweep_gauss_pallas",
    "ess_transition_cols",
    "ess_transition_gauss_cols",
    "hier_regression",
    "hmc_sweep",
    "iid_normal",
    "nuts_sweep",
    "nuts_sweep_cols",
    "nuts_transition",
    "nuts_transition_cols",
    "pallas_hmc",
    "pallas_nuts",
    "warmup_column",
    "warmup_column_nuts",
]
