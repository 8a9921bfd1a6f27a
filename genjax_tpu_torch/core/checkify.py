"""Optional runtime checks, gated globally.

Counterpart of ``genjax_tpu/checkify.py`` (the public facade
``genjax_tpu_torch/checkify.py`` re-exports this module; it sits in ``core``
so that the checks' sites below the facade can reach it). Under
``do_checkify()`` the validity checks run; outside it (the default) nothing
is read and nothing runs.

A check whose flag is a Python ``bool`` raises at once. A check on a tensor
flag goes through one custom op, ``genjax_tpu_torch::check_all``: the op
reads the flag once (one host read) and raises where any entry is false. Its
``torch.func.vmap`` rule reduces the flag over the batch axis and calls the
op again, so the op at the bottom sees one flag and a failing lane raises
from inside any number of nested ``vmap``s. Where the reference's
``jax.experimental.checkify`` collects an error to throw after the
transform, the port raises at the check: a check never passes silently
under a transform. (``torch._assert_async`` has no batching rule, so it
cannot serve.)
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Any, Callable

import torch

from .handlers import GenJAXError

__all__ = [
    "CheckError",
    "check",
    "checkify_enabled",
    "constraint_validation_active",
    "do_checkify",
    "optional_check",
    "suppress_constraint_validation",
]

_ENABLED: list[bool] = [False]


class CheckError(GenJAXError):
    """A runtime check under ``do_checkify()`` failed."""


@contextmanager
def do_checkify():
    """Run the optional checks in this extent.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> with do_checkify():
    ...     g.Mask(torch.tensor(1.0), torch.tensor(False)).unmask()
    Traceback (most recent call last):
    ...
    genjax_tpu_torch.core.checkify.CheckError: Attempted to unmask an invalid Mask.
    """
    _ENABLED.append(True)
    try:
        yield
    finally:
        _ENABLED.pop()


def checkify_enabled() -> bool:
    return _ENABLED[-1]


def optional_check(check_fn: Callable[[], None]) -> None:
    """Run ``check_fn`` under ``do_checkify()`` only."""
    if checkify_enabled():
        check_fn()


_ERRORS: dict[str, type] = {}


@functools.cache
def _check_op():
    @torch.library.custom_op("genjax_tpu_torch::check_all", mutates_args=())
    def op(flag: torch.Tensor, message: str, error: str) -> torch.Tensor:
        if not bool(torch.all(flag)):
            raise _ERRORS.get(error, CheckError)(message)
        return torch.zeros((), dtype=torch.bool, device=flag.device)

    @op.register_fake
    def _(flag, message, error):
        return torch.zeros((), dtype=torch.bool, device=flag.device)

    def batched(info, in_dims, flag, message, error):
        # every lane's flag at once: the op below reads one
        return op(torch.all(flag).reshape(()), message, error), None

    op.register_vmap(batched)
    return op


def check(flag: Any, message: str, error: type = CheckError) -> None:
    """Raise ``error(message)`` unless ``flag`` holds (everywhere, for a
    tensor flag: in every entry and every lane of a ``vmap``)."""
    if isinstance(flag, bool):
        if not flag:
            raise error(message)
        return
    name = f"{error.__module__}.{error.__qualname__}"
    _ERRORS[name] = error
    _check_op()(torch.as_tensor(flag, dtype=torch.bool), message, name)


# ----------------------------------------------------------------------
# the constraint-address validation gate
# ----------------------------------------------------------------------

_VALIDATION_SUPPRESSED: list[bool] = [False]


@contextmanager
def suppress_constraint_validation():
    """Turn constraint-address validation off in this extent: ``switch``
    hands an unfiltered constraint to branches with different addresses,
    and a sibling branch's addresses are no typos."""
    _VALIDATION_SUPPRESSED.append(True)
    try:
        yield
    finally:
        _VALIDATION_SUPPRESSED.pop()


def constraint_validation_active() -> bool:
    return checkify_enabled() and not _VALIDATION_SUPPRESSED[-1]
