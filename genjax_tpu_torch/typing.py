"""The public typing names: the facade of ``core/typing_.py``.

Counterpart of ``genjax_tpu/typing.py``. The reference's array aliases name
``jax.Array``; the port's values are ``torch.Tensor``s.
"""

from .core.typing_ import Address, AddressComponent, R, StaticAddress, static_check_supports_grad

__all__ = ["Address", "AddressComponent", "R", "StaticAddress", "static_check_supports_grad"]
