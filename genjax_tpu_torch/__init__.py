"""genjax_tpu_torch: the PyTorch/CUDA port of ``genjax_tpu``.

The port imports torch, numpy and scipy, never JAX. Names follow the JAX
package; randomness comes from explicit keys (``core.keys``: JAX's threefry
keys, which draw on the trace path what the JAX package draws from the same
key) or ``torch.Generator`` objects. It
carries the GFI (``simulate``, ``assess``, ``generate``, ``project``,
``edit`` and ``update``), ``@gen``, the reference's 48 distributions and
``torch_distribution``, the regression, GP and Poisson GLM models, the trace path (the ``HMC`` and ``NUTS`` edit requests, ``mh``,
``run_chains``, the batched ``run_chains_hmc`` and ``run_chains_nuts``), the
one-call drivers ``inference.sample_posterior`` (seven algorithms) and
``sample_logdensity`` with split-R̂ and ESS, the column samplers whose
sweeps are CUDA kernels in ``kernels/csrc``: HMC (``hmc_sweep.cu``), NUTS
(``nuts_sweep.cu``) and Gaussian elliptical slice sampling
(``ess_gauss_sweep.cu``), and the column samplers that are torch on the
card, as the reference's are XLA: ChEES, parallel tempering, the dense
metric, SVGD and SG-MCMC (``kernels.chees``, ``pt``, ``dense_mass``,
``svgd``, ``sgld``), and the combinators (``vmap``, ``scan``, ``switch``,
``mask``, ``dimap``, ``repeat``, ``or_else``, ``mix`` and the derived
iterations, also as postfix methods such as ``kernel.scan(n=...)``) with the
indexed, masked and switch choice maps and the ``IndexRequest`` and
``VectorRequest`` edits, and the state-space models of ``models.ssm``;
and SMC and GenSP (``Target``, ``ImportanceK``, ``ChangeTarget``,
``Marginal``, ``inference.tempered_smc`` and its adaptive ladder, the
``MALA`` and ``Rejuvenate`` moves, the particle filter and resamplers of
``parallel``, the Kalman oracle ``dists.LinearGaussianSSM`` and the
mixture models), torch on the card, as the reference's are XLA; and ADEV
(``adev``: ``@expectation`` and its gradient estimators) with variational
inference (``vi``: the ELBO, IWELBO and wake losses and ``fit``;
``inference.advi``), MAP and Laplace estimation (``inference.fit_map``,
``laplace_approximation``), torch on the card as well; and the discrete
and trace-level families: the discrete HMM's exact posterior
(``dists.DiscreteHMM``) and dense-HMM tools, exact enumeration and
enumerative Gibbs, particle Gibbs and PMMH, the ``EllipticalSlice`` and
``SliceSample`` requests, involutive MCMC, posterior predictive checks,
simulation-based calibration, and the PPCA, BNN and HMM models; and the
population and column-density algorithms (ABC, SMC², ChEES-tempered SMC,
nested sampling, Pathfinder, WAIC/PSIS-LOO) with checkpointed resume of
``inference.sample_posterior`` (``io``); and the incremental edit of ``@gen``
bodies and ``Dimap`` (``core.changes``), the runtime checks (``checkify``,
``typecheck``), the time-travel debugger (``debug``, ``time_travel``), named
effects and staging (``core.primitive``, ``core.staging``) and the facades
``incremental``, ``typing``, ``pretty`` and ``experimental``.
"""

from .core import (
    AddressReuse,
    Closure,
    Const,
    GenJAXError,
    MissingAddress,
    NotTracedError,
    Pytree,
)
from .core.diff import Argdiffs, Diff, NoChange, Retdiff, UnknownChange
from .core.staging import FlagOp
from .dists import Distribution, DistributionTrace, ExactDensity, exact_density, torch_distribution
from .dists.catalog import *  # noqa: F401,F403  (the 48 distributions)
from .dists import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
    HMMPosterior,
    LGSSMParams,
    LinearGaussianSSM,
    ffbs,
    forward_backward,
    forward_backward_parallel,
    forward_filtering_backward_sampling,
    forward_parallel,
    hmm_em,
    hmm_log_marginal,
    hmm_posterior_sample,
    kalman_filter,
    kalman_filter_parallel,
    kalman_predict,
    kalman_smoother,
    kalman_smoother_parallel,
    kalman_update,
    lgssm_em,
    viterbi,
    viterbi_parallel,
)
from .dists import catalog as _catalog
from .generative import (
    Arguments,
    C,
    ChoiceMap,
    DiffAnnotate,
    EditRequest,
    EmptyRequest,
    GenerativeFunction,
    GenerativeFunctionClosure,
    IndexRequest,
    Mask,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Regenerate,
    S,
    Score,
    Selection,
    Trace,
    Update,
    VectorRequest,
    Weight,
)
from .generative.choice_map import ChoiceMapBuilder
from .generative.concepts import Retval
from .generative.selection import SelectionBuilder
from .combinators import (
    MaskCombinator,
    ScanCombinator,
    SwitchCombinator,
    VmapCombinator,
    accumulate,
    contramap,
    dimap,
    iterate,
    iterate_final,
    masked_iterate,
    masked_iterate_final,
    mix,
    or_else,
    repeat,
    scan,
    switch,
    vmap,
)
from .combinators import map as map_  # keeps the builtin in * imports
from .combinators.mask_comb import mask as mask_combinator
from . import adev, checkify, debug, experimental, incremental, io, parallel, pretty as _pretty, time_travel, typecheck, typing
from .checkify import do_checkify
from .core import (
    Address,
    AddressComponent,
    Environment,
    InitialStylePrimitive,
    PythonicPytree,
    R,
    StatefulHandler,
    get_shaped_aval,
    initial_style_bind,
    nth,
    stage,
    stateful,
    to_shape_fn,
)
from .debug import TimeTravelingDebugger, rec, tag, time_machine
from .pretty import pretty
from .inference import (
    Algorithm,
    ChangeTarget,
    Importance,
    ImportanceK,
    Marginal,
    MHChainResult,
    ParticleCollection,
    SMCAlgorithm,
    Target,
    marginal,
    mh,
    run_chain,
    run_chains,
    run_chains_hmc,
    run_chains_nuts,
)
from .inference.requests import (
    HMC,
    MALA,
    NUTS,
    EllipticalSlice,
    Rejuvenate,
    SafeHMC,
    SliceSample,
    mh_accept,
    selection_gradient,
)
from .inference import vi
from .lang import StaticGenerativeFunction, StaticRequest, StaticTrace, gen, trace

__all__ = sorted(
    {
        "Algorithm",
        "DiscreteHMM",
        "DiscreteHMMConfiguration",
        "HMMPosterior",
        "LGSSMParams",
        "LinearGaussianSSM",
        "TimeTravelingDebugger",
        "core",
        "ffbs",
        "forward_backward",
        "forward_backward_parallel",
        "forward_filtering_backward_sampling",
        "forward_parallel",
        "hmm_em",
        "hmm_log_marginal",
        "hmm_posterior_sample",
        "kalman_filter",
        "kalman_filter_parallel",
        "kalman_predict",
        "kalman_smoother",
        "kalman_smoother_parallel",
        "kalman_update",
        "lgssm_em",
        "viterbi",
        "viterbi_parallel",
        "Address",
        "AddressComponent",
        "AddressReuse",
        "Argdiffs",
        "Environment",
        "InitialStylePrimitive",
        "PythonicPytree",
        "R",
        "StatefulHandler",
        "checkify",
        "debug",
        "do_checkify",
        "experimental",
        "get_shaped_aval",
        "incremental",
        "initial_style_bind",
        "nth",
        "pretty",
        "rec",
        "stage",
        "stateful",
        "tag",
        "time_machine",
        "time_travel",
        "to_shape_fn",
        "typecheck",
        "typing",
        "Arguments",
        "C",
        "ChangeTarget",
        "ChoiceMap",
        "ChoiceMapBuilder",
        "Closure",
        "Const",
        "Diff",
        "DiffAnnotate",
        "Distribution",
        "DistributionTrace",
        "EditRequest",
        "EmptyRequest",
        "EllipticalSlice",
        "ExactDensity",
        "FlagOp",
        "GenJAXError",
        "GenerativeFunction",
        "GenerativeFunctionClosure",
        "HMC",
        "Importance",
        "ImportanceK",
        "IndexRequest",
        "MALA",
        "MHChainResult",
        "Marginal",
        "Mask",
        "MaskCombinator",
        "MissingAddress",
        "NUTS",
        "NoChange",
        "NotSupportedEditRequest",
        "NotTracedError",
        "ParticleCollection",
        "PrimitiveEditRequest",
        "Pytree",
        "Regenerate",
        "Rejuvenate",
        "Retdiff",
        "Retval",
        "S",
        "SMCAlgorithm",
        "SafeHMC",
        "ScanCombinator",
        "Score",
        "Selection",
        "SelectionBuilder",
        "SliceSample",
        "StaticGenerativeFunction",
        "StaticRequest",
        "StaticTrace",
        "SwitchCombinator",
        "Target",
        "Trace",
        "UnknownChange",
        "Update",
        "VectorRequest",
        "VmapCombinator",
        "Weight",
        "accumulate",
        "adev",
        "beta",
        "categorical",
        "contramap",
        "dimap",
        "exact_density",
        "flip",
        "gen",
        "iterate",
        "iterate_final",
        "log_normal",
        "map_",
        "marginal",
        "mask_combinator",
        "masked_iterate",
        "masked_iterate_final",
        "mh",
        "mh_accept",
        "mix",
        "mv_normal",
        "mv_normal_diag",
        "normal",
        "or_else",
        "io",
        "parallel",
        "repeat",
        "run_chain",
        "run_chains",
        "run_chains_hmc",
        "run_chains_nuts",
        "scan",
        "selection_gradient",
        "switch",
        "torch_distribution",
        "trace",
        "vi",
        "vmap",
        *_catalog.__all__,
    }
)
