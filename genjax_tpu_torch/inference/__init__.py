"""Inference library: GenSP targets and algorithms, SMC and tempered SMC,
MCMC runners and the moves they run as edit requests, the one-call drivers
``sample_posterior`` and ``sample_logdensity`` and their convergence
diagnostics, variational inference (the ADEV losses of ``vi`` and ADVI),
MAP and Laplace estimation, exact enumeration and enumerative Gibbs,
particle Gibbs and PMMH, involutive MCMC, posterior predictive checks and
simulation-based calibration, and the population and column-density
algorithms: ABC, SMC², ChEES-tempered SMC, nested sampling, Pathfinder, and
WAIC/PSIS-LOO model comparison.

As in the reference, the public names ``smc2``, ``advi`` and ``pathfinder``
are the functions, not the modules; the ABC module is ``abc_``."""

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

from . import abc as abc_
from . import nested
from .abc import ABCRejectionResult, ABCSMCResult, abc_rejection, abc_smc, column_weighted_moments

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
from .model_comparison import ELPDResult, compare, psis_loo, waic
from .nested import NestedSamplingResult, column_nested_sampling, nested_sampling
from .pathfinder import (
    MultiPathfinderResult,
    PathfinderPosterior,
    PathfinderResult,
    column_pathfinder,
    multi_pathfinder,
    pathfinder,
)
from .mcmc import MHChainResult, mh, run_chain, run_chains, run_chains_hmc, run_chains_nuts
from .pgibbs import CSMCSweepResult, PGibbsResult, PMMHResult, csmc_sweep, particle_gibbs, pmmh
from .predictive import posterior_predictive
from .sample import LogdensitySamples, PosteriorSamples, sample_logdensity, sample_posterior
from .sbc import SBCResult, sbc_ranks, sbc_uniformity
from .smc2 import SMC2Result, smc2
from .smc_chees import ChEESTemperedResult, chees_tempered_smc, column_tempered_chees
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
    "abc_",
    "abc_rejection",
    "abc_smc",
    "ABCRejectionResult",
    "ABCSMCResult",
    "adaptation",
    "adaptive_tempered_smc",
    "AdaptiveTemperedSMCResult",
    "advi",
    "ADVIPosterior",
    "ADVIResult",
    "Algorithm",
    "build_test_against_exact_inference",
    "ChangeTarget",
    "chees_tempered_smc",
    "ChEESTemperedResult",
    "column_advi",
    "column_nested_sampling",
    "column_pathfinder",
    "column_tempered_chees",
    "column_weighted_moments",
    "compare",
    "csmc_sweep",
    "CSMCSweepResult",
    "diagnostics",
    "DiscreteHMMInferenceProblem",
    "ELPDResult",
    "enum_move",
    "enum_vmap_move",
    "enumerate_",
    "enumerate_posterior",
    "EnumerationResult",
    "enumerative_gibbs",
    "enumerative_gibbs_vmap",
    "ess",
    "exact_testbed",
    "fit_map",
    "geometric_ladder",
    "gibbs",
    "gibbs_sweep",
    "GibbsInfo",
    "GibbsSweepResult",
    "Importance",
    "ImportanceK",
    "involutive",
    "involutive_mh",
    "involutive_move",
    "InvolutiveInfo",
    "laplace_approximation",
    "LaplaceResult",
    "learning",
    "LogdensitySamples",
    "MAPResult",
    "Marginal",
    "marginal",
    "mcmc",
    "mh",
    "mh_move",
    "MHChainResult",
    "multi_pathfinder",
    "MultiPathfinderResult",
    "nested",
    "nested_sampling",
    "NestedSamplingResult",
    "particle_gibbs",
    "ParticleCollection",
    "pathfinder",
    "PathfinderPosterior",
    "PathfinderResult",
    "pgibbs",
    "PGibbsResult",
    "pmmh",
    "PMMHResult",
    "posterior_predictive",
    "PosteriorSamples",
    "predictive",
    "psis_loo",
    "requests",
    "run_chain",
    "run_chains",
    "run_chains_hmc",
    "run_chains_nuts",
    "sample",
    "sample_logdensity",
    "sample_posterior",
    "SampleDistribution",
    "sbc_ranks",
    "sbc_uniformity",
    "SBCResult",
    "smc",
    "smc2",
    "SMC2Result",
    "SMCAlgorithm",
    "sp",
    "split_rhat",
    "Target",
    "tempered",
    "tempered_smc",
    "TemperedSMCResult",
    "vi",
    "waic",
]
