"""Type checks at the boundary of the generative function interface.

Counterpart of ``genjax_tpu/typecheck.py`` (the public facade
``genjax_tpu_torch/typecheck.py`` re-exports this module; it sits in
``generative`` so that ``@gen``'s methods can reach it). Cheap ``isinstance``
checks of the interface's contract, which raise a ``GFITypeError`` with a
targeted message where a wrong value would otherwise fail deep inside torch:
the source of randomness is a key (``core/keys.py``, the reference's PRNG
key) or a ``torch.Generator``, a constraint is a ``ChoiceMap``, a selection a ``Selection``,
and arguments come as a tuple. The reference's opt-in deep checking
(``install_import_hook``) needs ``typeguard``, which the port does not use.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.keys import is_key
from .choice_map import ChoiceMap
from .selection import Selection


class GFITypeError(TypeError):
    """A generative function's method was called with the wrong kind of
    value."""


def check_key(gen: Any, what: str) -> None:
    """The source of randomness: a key (an int64 tensor of two 32-bit words,
    ``core.keys.key(seed)``), which draws what the reference draws from the
    same key, or a ``torch.Generator``.

    >>> check_key(42, "simulate")
    Traceback (most recent call last):
    ...
    genjax_tpu_torch.generative.typecheck.GFITypeError: simulate: expected a key or a torch.Generator as the source of randomness, got int. Make a key with genjax_tpu_torch.core.keys.key(seed), or a generator with torch.Generator(device).manual_seed(seed).
    """
    if not (isinstance(gen, torch.Generator) or is_key(gen)):
        raise GFITypeError(
            f"{what}: expected a key or a torch.Generator as the source of randomness, got "
            f"{type(gen).__name__}. Make a key with genjax_tpu_torch.core.keys.key(seed), "
            "or a generator with torch.Generator(device).manual_seed(seed)."
        )


def check_generator(gen: Any, what: str) -> None:
    """A ``torch.Generator``, where the draws under a key are not reproduced
    yet: a key raises, naming ``what``, rather than drawing in law."""
    if not isinstance(gen, torch.Generator):
        raise GFITypeError(
            f"{what}: drawing under a key is not reproduced here; pass a torch.Generator, got "
            f"{type(gen).__name__}"
        )


def check_args(args: Any, what: str) -> None:
    if not isinstance(args, tuple):
        raise GFITypeError(
            f"{what}: arguments must be passed as a tuple, got {type(args).__name__}. "
            "For a single argument write (x,)."
        )


def check_constraint(constraint: Any, what: str) -> None:
    if not isinstance(constraint, ChoiceMap):
        hint = " Build one with ChoiceMap.d({...}) or C[addr].set(v)." if isinstance(constraint, dict) else ""
        raise GFITypeError(
            f"{what}: the constraint must be a ChoiceMap, got {type(constraint).__name__}.{hint}"
        )


def check_selection(selection: Any, what: str) -> None:
    if not isinstance(selection, Selection):
        raise GFITypeError(
            f"{what}: expected a Selection (e.g. S['x'] or Selection.all()), got {type(selection).__name__}."
        )


def install_import_hook(packages: Any = "genjax_tpu_torch"):
    """The reference instruments ``packages`` with ``typeguard``-checked
    signatures for development runs. The port does not depend on
    ``typeguard`` (the CUDA machines it runs on do not have it), so this
    raises ``ImportError``."""
    raise ImportError(
        "install_import_hook needs typeguard, which genjax_tpu_torch does not use; "
        "the boundary checks (check_key, check_args, check_constraint, check_selection) run always"
    )
