"""Column-layout kernels: the fused HMC and NUTS sweeps, their warmups and
the model bridge."""

from .bodies import Body, hier_regression, iid_normal
from .hmc import hmc_sweep, pallas_hmc, warmup_column
from .model_interface import ColumnPacker, column_hmc, column_logdensity, column_nuts
from .nuts import nuts_sweep_cols, nuts_transition_cols
from .nuts_pallas import nuts_sweep, pallas_nuts, warmup_column_nuts

__all__ = [
    "Body",
    "ColumnPacker",
    "column_hmc",
    "column_logdensity",
    "column_nuts",
    "hier_regression",
    "hmc_sweep",
    "iid_normal",
    "nuts_sweep",
    "nuts_sweep_cols",
    "nuts_transition_cols",
    "pallas_hmc",
    "pallas_nuts",
    "warmup_column",
    "warmup_column_nuts",
]
