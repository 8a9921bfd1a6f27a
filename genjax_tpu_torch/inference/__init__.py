"""Inference library: GenSP targets and algorithms, SMC and tempered SMC,
MCMC runners and the moves they run as edit requests, the one-call drivers
``sample_posterior`` and ``sample_logdensity`` and their convergence
diagnostics, variational inference (the ADEV losses of ``vi`` and ADVI),
MAP and Laplace estimation, exact enumeration and enumerative Gibbs,
particle Gibbs and PMMH, involutive MCMC, posterior predictive checks and
simulation-based calibration."""

from . import (
    adaptation,
    diagnostics,
    enumerate_,
    exact_testbed,
    gibbs,
    involutive,
    learning,
    mcmc,
    pgibbs,
    predictive,
    requests,
    sample,
    smc,
    sp,
    tempered,
    vi,
)

# (the public name ``advi`` is the fit function, not the module)
from .advi import ADVIPosterior, ADVIResult, advi, column_advi
from .learning import LaplaceResult, MAPResult, fit_map, laplace_approximation
from .diagnostics import ess, split_rhat
from .enumerate_ import EnumerationResult, enumerate_posterior
from .exact_testbed import DiscreteHMMInferenceProblem, build_test_against_exact_inference
from .gibbs import (
    GibbsInfo,
    GibbsSweepResult,
    enum_move,
    enum_vmap_move,
    enumerative_gibbs,
    enumerative_gibbs_vmap,
    gibbs_sweep,
    mh_move,
)
from .involutive import InvolutiveInfo, involutive_mh, involutive_move
from .mcmc import MHChainResult, mh, run_chain, run_chains, run_chains_hmc, run_chains_nuts
from .pgibbs import CSMCSweepResult, PGibbsResult, PMMHResult, csmc_sweep, particle_gibbs, pmmh
from .predictive import posterior_predictive
from .sample import LogdensitySamples, PosteriorSamples, sample_logdensity, sample_posterior
from .sbc import SBCResult, sbc_ranks, sbc_uniformity
from .smc import ChangeTarget, Importance, ImportanceK, ParticleCollection, SMCAlgorithm
from .sp import Algorithm, Marginal, SampleDistribution, Target, marginal
from .tempered import (
    AdaptiveTemperedSMCResult,
    TemperedSMCResult,
    adaptive_tempered_smc,
    geometric_ladder,
    tempered_smc,
)

__all__ = [
    "ADVIPosterior",
    "ADVIResult",
    "AdaptiveTemperedSMCResult",
    "Algorithm",
    "CSMCSweepResult",
    "ChangeTarget",
    "DiscreteHMMInferenceProblem",
    "EnumerationResult",
    "GibbsInfo",
    "GibbsSweepResult",
    "Importance",
    "ImportanceK",
    "InvolutiveInfo",
    "LaplaceResult",
    "LogdensitySamples",
    "MAPResult",
    "MHChainResult",
    "Marginal",
    "PGibbsResult",
    "PMMHResult",
    "ParticleCollection",
    "PosteriorSamples",
    "SBCResult",
    "SMCAlgorithm",
    "SampleDistribution",
    "Target",
    "TemperedSMCResult",
    "adaptation",
    "adaptive_tempered_smc",
    "advi",
    "build_test_against_exact_inference",
    "column_advi",
    "csmc_sweep",
    "diagnostics",
    "enum_move",
    "enum_vmap_move",
    "enumerate_",
    "enumerate_posterior",
    "enumerative_gibbs",
    "enumerative_gibbs_vmap",
    "ess",
    "exact_testbed",
    "fit_map",
    "geometric_ladder",
    "gibbs",
    "gibbs_sweep",
    "involutive",
    "involutive_mh",
    "involutive_move",
    "laplace_approximation",
    "learning",
    "marginal",
    "mcmc",
    "mh",
    "mh_move",
    "particle_gibbs",
    "pgibbs",
    "pmmh",
    "posterior_predictive",
    "predictive",
    "requests",
    "run_chain",
    "run_chains",
    "run_chains_hmc",
    "run_chains_nuts",
    "sample",
    "sample_logdensity",
    "sample_posterior",
    "sbc_ranks",
    "sbc_uniformity",
    "smc",
    "sp",
    "split_rhat",
    "tempered",
    "tempered_smc",
    "vi",
]
