"""genjax_tpu_torch: the PyTorch/CUDA port of ``genjax_tpu``.

The port imports torch, numpy and scipy, never JAX. Names follow the JAX
package; randomness comes from explicit ``torch.Generator`` objects. It
carries the GFI (``simulate``, ``assess``, ``generate``, ``project``,
``edit`` and ``update``), ``@gen``, six distributions, the regression and GP
models, the trace path (the ``HMC`` and ``NUTS`` edit requests, ``mh``,
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
mixture models), torch on the card, as the reference's are XLA.
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
from .core.diff import Diff, NoChange, UnknownChange
from .dists import (
    Distribution,
    ExactDensity,
    beta,
    categorical,
    exact_density,
    flip,
    log_normal,
    mv_normal,
    mv_normal_diag,
    normal,
)
from .generative import (
    C,
    ChoiceMap,
    DiffAnnotate,
    EditRequest,
    EmptyRequest,
    GenerativeFunction,
    IndexRequest,
    Mask,
    NotSupportedEditRequest,
    Regenerate,
    S,
    Selection,
    Trace,
    Update,
    VectorRequest,
)
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
from . import parallel
from .inference import (
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
from .inference.requests import HMC, MALA, NUTS, Rejuvenate, SafeHMC, mh_accept, selection_gradient
from .lang import StaticGenerativeFunction, StaticRequest, StaticTrace, gen

__all__ = [
    "AddressReuse",
    "C",
    "ChangeTarget",
    "ChoiceMap",
    "Closure",
    "Const",
    "Diff",
    "DiffAnnotate",
    "Distribution",
    "EditRequest",
    "EmptyRequest",
    "ExactDensity",
    "GenJAXError",
    "GenerativeFunction",
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
    "Pytree",
    "Regenerate",
    "Rejuvenate",
    "S",
    "SMCAlgorithm",
    "SafeHMC",
    "ScanCombinator",
    "Selection",
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
    "accumulate",
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
    "mv_normal",
    "mv_normal_diag",
    "mix",
    "normal",
    "or_else",
    "parallel",
    "repeat",
    "run_chain",
    "run_chains",
    "run_chains_hmc",
    "run_chains_nuts",
    "scan",
    "selection_gradient",
    "switch",
    "vmap",
]
