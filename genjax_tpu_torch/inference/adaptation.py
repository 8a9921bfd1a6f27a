"""Re-export shim: the MCMC warmup adaptation estimators.

Counterpart of ``genjax_tpu/inference/adaptation.py``. The implementation
lives in ``kernels/adaptation.py``, below both ``kernels/`` and
``inference/``, so that every consumer imports downward; this keeps the
public path ``genjax_tpu_torch.inference.adaptation``.
"""

from ..kernels.adaptation import (
    StepSizeAdaptState,
    cross_chain_inv_mass,
    dual_averaging_update,
    multiplicative_nudge,
    windowed_warmup,
)

__all__ = [
    "StepSizeAdaptState",
    "cross_chain_inv_mass",
    "dual_averaging_update",
    "multiplicative_nudge",
    "windowed_warmup",
]
