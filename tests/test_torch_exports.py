"""The port's public names against the reference's: every name of
``genjax_tpu.kernels.__all__`` and the public API of
``genjax_tpu.inference.sample`` resolves in ``genjax_tpu_torch``, and the
dual-averaging state is made on the device its chains live on."""

import pytest
import torch

import genjax_tpu.inference.sample as ref_sample
import genjax_tpu.kernels as ref_kernels
import genjax_tpu_torch.inference as inference
import genjax_tpu_torch.kernels as kernels
from genjax_tpu_torch.inference import sample
from genjax_tpu_torch.kernels.adaptation import StepSizeAdaptState

SAMPLE_API = ["PosteriorSamples", "LogdensitySamples", "sample_posterior", "sample_logdensity"]


@pytest.mark.parametrize("name", sorted(ref_kernels.__all__))
def test_every_reference_kernel_name_resolves(name):
    assert callable(getattr(kernels, name)), name
    assert name in kernels.__all__


@pytest.mark.parametrize("name", SAMPLE_API)
def test_the_sample_api_resolves(name):
    assert hasattr(ref_sample, name)
    assert getattr(sample, name) is getattr(inference, name)
    assert name in sample.__all__ and name in inference.__all__


@pytest.mark.parametrize("eps0", [0.1, [0.1, 0.2, 0.3]])
def test_step_size_state_init_places_every_leaf(eps0):
    st = StepSizeAdaptState.init(eps0, device="meta")
    leaves = (st.log_eps, st.log_eps_bar, st.h_bar, st.step, st.mu)
    assert all(leaf.device.type == "meta" for leaf in leaves)
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    assert all(leaf.shape == torch.as_tensor(eps0).shape for leaf in (st.log_eps, st.log_eps_bar, st.h_bar, st.mu))
    cpu = StepSizeAdaptState.init(eps0)
    assert cpu.log_eps.device.type == "cpu" and float(cpu.h_bar.sum()) == 0.0


SMC_NAMES = {
    "inference": ["Algorithm", "ChangeTarget", "Importance", "ImportanceK", "Marginal", "ParticleCollection",
                  "SMCAlgorithm", "SampleDistribution", "Target", "marginal", "AdaptiveTemperedSMCResult",
                  "TemperedSMCResult", "adaptive_tempered_smc", "geometric_ladder", "tempered_smc"],
    "inference.requests": ["MALA", "Rejuvenate"],
    "dists": ["LGSSMParams", "LinearGaussianSSM", "ffbs", "kalman_filter", "kalman_filter_parallel",
              "kalman_predict", "kalman_smoother", "kalman_smoother_parallel", "kalman_update", "lgssm_em"],
    "models": ["dp_mixture_model", "gaussian_mixture_model", "logistic_regression"],
    "parallel": ["SSMParticleFilter", "effective_sample_size", "multinomial_indices", "redistribute",
                 "resample_particles", "residual_indices", "stratified_counts", "stratified_indices",
                 "systematic_counts", "systematic_indices"],
    "": ["ChangeTarget", "Importance", "ImportanceK", "MALA", "Marginal", "ParticleCollection", "Rejuvenate",
         "SMCAlgorithm", "Target", "marginal", "parallel"],
}


@pytest.mark.parametrize("module,name", [(m, n) for m, names in SMC_NAMES.items() for n in names])
def test_smc_names_resolve(module, name):
    """Slice 11's names resolve where the reference exports them, and are in
    the port's ``__all__`` there."""
    import importlib

    ref = importlib.import_module("genjax_tpu" + ("." + module if module else ""))
    port = importlib.import_module("genjax_tpu_torch" + ("." + module if module else ""))
    assert hasattr(ref, name), name
    assert getattr(port, name) is not None and name in port.__all__


SLICE13_NAMES = {
    "inference": ["CSMCSweepResult", "EnumerationResult", "GibbsInfo", "GibbsSweepResult", "InvolutiveInfo",
                  "PGibbsResult", "PMMHResult", "SBCResult", "csmc_sweep", "enum_move", "enum_vmap_move",
                  "enumerate_", "enumerate_posterior", "enumerative_gibbs", "enumerative_gibbs_vmap", "gibbs",
                  "gibbs_sweep", "involutive", "involutive_mh", "involutive_move", "mh_move", "particle_gibbs",
                  "pgibbs", "pmmh", "posterior_predictive", "predictive", "sbc_ranks", "sbc_uniformity"],
    "inference.requests": ["EllipticalSlice", "SliceSample"],
    "inference.exact_testbed": ["DiscreteHMMInferenceProblem", "build_test_against_exact_inference"],
    "dists": ["DiscreteHMM", "DiscreteHMMConfiguration", "HMMPosterior", "forward_backward",
              "forward_backward_parallel", "forward_filtering_backward_sampling", "forward_parallel", "hmm_em",
              "hmm_log_marginal", "hmm_posterior_sample", "viterbi", "viterbi_parallel"],
    "models": ["bayesian_nn", "bnn_exact_linear_posterior", "bnn_predict", "dense_hmm_model",
               "discrete_hmm_model", "ppca_em", "ppca_log_likelihood", "ppca_ml", "ppca_model", "ppca_posterior"],
    "": ["EllipticalSlice", "SliceSample"],
}


@pytest.mark.parametrize("module,name", [(m, n) for m, names in SLICE13_NAMES.items() for n in names])
def test_slice13_names_resolve(module, name):
    """Slice 13's names resolve where the reference exports them, and are in
    the port's ``__all__`` there (a module's own names, where the reference
    has no ``__all__``, resolve on the module)."""
    import importlib

    ref = importlib.import_module("genjax_tpu" + ("." + module if module else ""))
    port = importlib.import_module("genjax_tpu_torch" + ("." + module if module else ""))
    assert hasattr(ref, name), name
    assert getattr(port, name) is not None
    assert name in getattr(port, "__all__", [name])


SLICE14_NAMES = {
    "inference": ["ABCRejectionResult", "ABCSMCResult", "ChEESTemperedResult", "ELPDResult", "MultiPathfinderResult",
                  "NestedSamplingResult", "PathfinderPosterior", "PathfinderResult", "SMC2Result", "abc_",
                  "abc_rejection", "abc_smc", "chees_tempered_smc", "column_nested_sampling", "column_pathfinder",
                  "column_tempered_chees", "column_weighted_moments", "compare", "multi_pathfinder", "nested",
                  "nested_sampling", "pathfinder", "psis_loo", "smc2", "waic"],
    "io": ["check_meta_matches", "load_segment_state", "restore_pytree", "save_pytree", "save_segment_state"],
    "": ["io"],
}


@pytest.mark.parametrize("module,name", [(m, n) for m, names in SLICE14_NAMES.items() for n in names])
def test_slice14_names_resolve(module, name):
    """Slice 14's names resolve where the reference exports them, and are in
    the port's ``__all__`` there."""
    import importlib

    ref = importlib.import_module("genjax_tpu" + ("." + module if module else ""))
    port = importlib.import_module("genjax_tpu_torch" + ("." + module if module else ""))
    assert hasattr(ref, name), name
    assert getattr(port, name) is not None and name in port.__all__


@pytest.mark.parametrize("name,kind", [("smc2", "function"), ("pathfinder", "function"), ("abc_", "module"),
                                       ("nested", "module")])
def test_slice14_names_are_what_the_reference_makes_them(name, kind):
    import importlib
    import types

    ref = importlib.import_module("genjax_tpu.inference")
    port = importlib.import_module("genjax_tpu_torch.inference")
    want = types.ModuleType if kind == "module" else types.FunctionType
    assert isinstance(getattr(ref, name), want) and isinstance(getattr(port, name), want)


def _reference_parallel_names():
    import genjax_tpu.parallel as ref_parallel

    return sorted(set(ref_parallel.__all__) - {"shard_map_compat"})


@pytest.mark.parametrize("name", _reference_parallel_names())
def test_every_reference_parallel_name_resolves(name):
    """Every name of the reference's ``parallel.__all__`` resolves in the
    port's ``parallel`` and is in its ``__all__``, but ``shard_map_compat``
    (no ``shard_map`` to call: a deviation)."""
    import genjax_tpu_torch.parallel as parallel

    assert getattr(parallel, name) is not None
    assert name in parallel.__all__


def test_the_parallel_additions_resolve():
    import genjax_tpu_torch.parallel as parallel

    for name in ("gather_batch", "collective_log", "collective_counts"):
        assert callable(getattr(parallel, name)) and name in parallel.__all__
    assert not hasattr(parallel, "shard_map_compat")
