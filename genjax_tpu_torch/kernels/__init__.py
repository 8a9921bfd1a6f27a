"""Column-layout kernels: the fused HMC, NUTS and Gaussian elliptical-slice
sweeps, the generic elliptical slice sampler, the warmups, the column
samplers ChEES, parallel tempering, dense-metric HMC, SVGD and SG-MCMC, and
the model bridge."""

from .adaptation import (
    StepSizeAdaptState,
    cross_chain_inv_mass,
    dual_averaging_update,
    multiplicative_nudge,
    windowed_warmup,
)
from .bodies import Body, hier_regression, iid_normal
from .chees import ChEESInfo, chees_hmc
from .dense_mass import cross_chain_cov, hmc_sweep_dense_cols, warmup_column_dense, whiten_logdensity
from .elliptical import (
    ess_gauss_sweep,
    ess_sweep_cols,
    ess_sweep_gauss_cols,
    ess_sweep_gauss_pallas,
    ess_transition_cols,
    ess_transition_gauss_cols,
)
from .hmc import hmc_sweep, pallas_hmc, warmup_column
from .model_interface import (
    ColumnPacker,
    column_chees,
    column_hmc,
    column_logdensity,
    column_nuts,
    column_pt,
    column_svgd,
)
from .nuts import nuts_sweep_cols, nuts_transition, nuts_transition_cols
from .nuts_pallas import nuts_sweep, pallas_nuts, warmup_column_nuts
from .pt import PTInfo, geometric_ladder, pt_hmc
from .sgld import full_grad_cols, minibatch_grad_cols, sghmc_sweep_cols, sgld_sweep_cols
from .svgd import median_bandwidth, rbf_kernel_and_grad, svgd

__all__ = [
    "Body",
    "ChEESInfo",
    "ColumnPacker",
    "PTInfo",
    "StepSizeAdaptState",
    "chees_hmc",
    "column_chees",
    "column_hmc",
    "column_logdensity",
    "column_nuts",
    "column_pt",
    "column_svgd",
    "cross_chain_cov",
    "cross_chain_inv_mass",
    "dual_averaging_update",
    "ess_gauss_sweep",
    "ess_sweep_cols",
    "ess_sweep_gauss_cols",
    "ess_sweep_gauss_pallas",
    "ess_transition_cols",
    "ess_transition_gauss_cols",
    "full_grad_cols",
    "geometric_ladder",
    "hier_regression",
    "hmc_sweep",
    "hmc_sweep_dense_cols",
    "iid_normal",
    "median_bandwidth",
    "minibatch_grad_cols",
    "multiplicative_nudge",
    "nuts_sweep",
    "nuts_sweep_cols",
    "nuts_transition",
    "nuts_transition_cols",
    "pallas_hmc",
    "pallas_nuts",
    "pt_hmc",
    "rbf_kernel_and_grad",
    "sghmc_sweep_cols",
    "sgld_sweep_cols",
    "svgd",
    "warmup_column",
    "warmup_column_dense",
    "warmup_column_nuts",
    "whiten_logdensity",
    "windowed_warmup",
]
