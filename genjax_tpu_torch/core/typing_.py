"""Static checks on values.

Counterpart of the parts of ``genjax_tpu/core/typing_.py`` that the port
uses: the address aliases, the return-type variable ``R`` and the gradient
path's check.
"""

from __future__ import annotations

from typing import Any, TypeVar, Union

import torch

#: An address in a choice map or trace: a string, an index, or a tuple of them.
Address = Any
#: One component of an address.
AddressComponent = Any
#: An address made of strings alone.
StaticAddress = Union[str, tuple]
#: A generic return type.
R = TypeVar("R")


def static_check_supports_grad(v: Any) -> bool:
    """True if ``v`` is a floating-point tensor (a differentiable leaf).
    Python numbers and integer or boolean tensors are not."""
    return isinstance(v, torch.Tensor) and v.is_floating_point()
