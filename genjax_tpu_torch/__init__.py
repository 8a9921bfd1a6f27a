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
``svgd``, ``sgld``).
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
    Mask,
    NotSupportedEditRequest,
    Regenerate,
    S,
    Selection,
    Trace,
    Update,
)
from .inference import MHChainResult, mh, run_chain, run_chains, run_chains_hmc, run_chains_nuts
from .inference.requests import HMC, NUTS, SafeHMC, mh_accept, selection_gradient
from .lang import StaticGenerativeFunction, StaticRequest, StaticTrace, gen

__all__ = [
    "AddressReuse",
    "C",
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
    "MHChainResult",
    "Mask",
    "MissingAddress",
    "NUTS",
    "NoChange",
    "NotSupportedEditRequest",
    "NotTracedError",
    "Pytree",
    "Regenerate",
    "S",
    "SafeHMC",
    "Selection",
    "StaticGenerativeFunction",
    "StaticRequest",
    "StaticTrace",
    "Trace",
    "UnknownChange",
    "Update",
    "beta",
    "exact_density",
    "flip",
    "gen",
    "log_normal",
    "mh",
    "mh_accept",
    "mv_normal",
    "mv_normal_diag",
    "normal",
    "run_chain",
    "run_chains",
    "run_chains_hmc",
    "run_chains_nuts",
    "selection_gradient",
]
