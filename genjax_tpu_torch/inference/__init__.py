"""Inference library: GenSP targets and algorithms, SMC and tempered SMC,
MCMC runners and the moves they run as edit requests, the one-call drivers
``sample_posterior`` and ``sample_logdensity`` and their convergence
diagnostics, variational inference (the ADEV losses of ``vi`` and ADVI),
and MAP and Laplace estimation."""

from . import adaptation, diagnostics, learning, mcmc, requests, sample, smc, sp, tempered, vi

# (the public name ``advi`` is the fit function, not the module)
from .advi import ADVIPosterior, ADVIResult, advi, column_advi
from .learning import LaplaceResult, MAPResult, fit_map, laplace_approximation
from .diagnostics import ess, split_rhat
from .mcmc import MHChainResult, mh, run_chain, run_chains, run_chains_hmc, run_chains_nuts
from .sample import LogdensitySamples, PosteriorSamples, sample_logdensity, sample_posterior
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
    "ChangeTarget",
    "Importance",
    "ImportanceK",
    "LaplaceResult",
    "LogdensitySamples",
    "MAPResult",
    "MHChainResult",
    "Marginal",
    "ParticleCollection",
    "PosteriorSamples",
    "SMCAlgorithm",
    "SampleDistribution",
    "Target",
    "TemperedSMCResult",
    "adaptation",
    "adaptive_tempered_smc",
    "advi",
    "column_advi",
    "diagnostics",
    "ess",
    "fit_map",
    "geometric_ladder",
    "laplace_approximation",
    "learning",
    "marginal",
    "mcmc",
    "mh",
    "requests",
    "run_chain",
    "run_chains",
    "run_chains_hmc",
    "run_chains_nuts",
    "sample",
    "sample_logdensity",
    "sample_posterior",
    "smc",
    "sp",
    "split_rhat",
    "tempered",
    "tempered_smc",
    "vi",
]
