"""Inference library: GenSP targets and algorithms, SMC and tempered SMC,
MCMC runners and the moves they run as edit requests, the one-call drivers
``sample_posterior`` and ``sample_logdensity`` and their convergence
diagnostics."""

from . import adaptation, diagnostics, mcmc, requests, sample, smc, sp, tempered
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
    "AdaptiveTemperedSMCResult",
    "Algorithm",
    "ChangeTarget",
    "Importance",
    "ImportanceK",
    "LogdensitySamples",
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
    "diagnostics",
    "ess",
    "geometric_ladder",
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
]
