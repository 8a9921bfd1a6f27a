"""Static checks on values.

Counterpart of the part of ``genjax_tpu/core/typing_.py`` that the gradient
path uses.
"""

from __future__ import annotations

from typing import Any

import torch


def static_check_supports_grad(v: Any) -> bool:
    """True if ``v`` is a floating-point tensor (a differentiable leaf).
    Python numbers and integer or boolean tensors are not."""
    return isinstance(v, torch.Tensor) and v.is_floating_point()
