"""Static checks on values.

Counterpart of ``genjax_tpu/core/typing_.py``: the address and array
aliases (a tensor where the reference names a JAX array; ``PRNGKey`` is the
key of ``core/keys.py``), the return-type variable ``R`` and the static
checks. As in ``core/staging.py``, only a Python value is concrete: every
tensor may differ between the lanes of a ``torch.func.vmap``. The
reference's ``nobeartype`` has no counterpart: the port uses no
``beartype``.
"""

from __future__ import annotations

from typing import Any, TypeVar, Union

import torch

from .keys import PRNGKey

#: A tensor, where the reference names a JAX array.
Array = torch.Tensor
#: A value that becomes a tensor: a tensor, a numpy array or a number.
ArrayLike = Union[torch.Tensor, "numpy.ndarray", float, int, bool]
FloatArray = Union[float, torch.Tensor]
IntArray = Union[int, torch.Tensor]
BoolArray = Union[bool, torch.Tensor]
#: A flag: a concrete Python bool or a bool tensor.
Flag = Union[bool, torch.Tensor]
ScalarFlag = Union[bool, torch.Tensor]
ScalarInt = Union[int, torch.Tensor]

#: An address in a choice map or trace: a string, an index, or a tuple of them.
Address = Any
#: One component of an address.
AddressComponent = Any
#: An address made of strings alone.
StaticAddress = Union[str, tuple]
#: A generic return type.
R = TypeVar("R")


def static_check_is_concrete(x: Any) -> bool:
    """True if ``x`` is concrete: no tensor (which may be batched under
    ``torch.func.vmap``), so Python may branch on it."""
    return not isinstance(x, torch.Tensor)


def static_check_supports_grad(v: Any) -> bool:
    """True if ``v`` is a floating-point tensor (a differentiable leaf).
    Python numbers and integer or boolean tensors are not."""
    return isinstance(v, torch.Tensor) and v.is_floating_point()
