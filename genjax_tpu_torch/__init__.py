"""genjax_tpu_torch: the PyTorch/CUDA port of ``genjax_tpu``.

The port imports torch, numpy and scipy, never JAX. Names follow the JAX
package; randomness comes from explicit ``torch.Generator`` objects. It
carries the GFI with ``simulate``, ``assess`` and ``generate``, ``@gen``,
six distributions, the regression and GP models, and the column samplers
whose sweeps are CUDA kernels in ``kernels/csrc``: HMC (``hmc_sweep.cu``),
NUTS (``nuts_sweep.cu``) and Gaussian elliptical slice sampling
(``ess_gauss_sweep.cu``).
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
    GenerativeFunction,
    Mask,
    S,
    Selection,
    Trace,
)
from .lang import StaticGenerativeFunction, StaticTrace, gen

__all__ = [
    "AddressReuse",
    "C",
    "ChoiceMap",
    "Closure",
    "Const",
    "Distribution",
    "ExactDensity",
    "GenJAXError",
    "GenerativeFunction",
    "Mask",
    "MissingAddress",
    "NotTracedError",
    "Pytree",
    "S",
    "Selection",
    "StaticGenerativeFunction",
    "StaticTrace",
    "Trace",
    "beta",
    "exact_density",
    "flip",
    "gen",
    "log_normal",
    "mv_normal",
    "mv_normal_diag",
    "normal",
]
