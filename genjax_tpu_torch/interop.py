"""Carrying state across from the JAX package, as numpy.

This module takes numpy arrays only, so the port never imports JAX: the
caller flattens JAX state to numpy on its side. Model constants such as a
regression's ``X`` need no conversion: ``hierarchical_regression(X)`` and
``linear_regression(X)`` take the numpy arrays as they are; a discrete
HMM's configuration crosses as its five numbers, and PPCA's parameters as
numpy arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .dists.discrete_hmm import DiscreteHMMConfiguration
from .generative.choice_map import ChoiceMap


def _component(c):
    # ``...`` stands for every index of a lane or time axis, as ``:`` does
    return slice(None) if c is Ellipsis else c


def choice_map_from_numpy(entries: Mapping[tuple, np.ndarray]) -> ChoiceMap:
    """``{address_tuple: array}`` -> ChoiceMap of CPU tensors. An address
    component ``...`` or ``slice(None)`` takes the array's leading axis as
    a lane or time axis (the layout of a ``vmap`` or ``scan`` trace's
    choices): ``{(..., "z"): zs}`` is ``C[:, "z"].set(zs)``, so a JAX
    ``ScanTrace``'s choices flattened to numpy cross as they are."""
    return ChoiceMap.from_mapping(
        (tuple(_component(c) for c in (addr if isinstance(addr, tuple) else (addr,))),
         torch.from_numpy(np.array(v)))
        for addr, v in entries.items()
    )


def columns_from_numpy(q: np.ndarray, device) -> torch.Tensor:
    """Column-layout positions ``(D, N)`` as a contiguous float32 tensor."""
    q = np.asarray(q)
    if q.ndim != 2:
        raise ValueError(f"columns are (D, N); got shape {q.shape}")
    return torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(device)


def discrete_hmm_configuration(numbers) -> DiscreteHMMConfiguration:
    """The configuration of the five numbers a reference
    ``DiscreteHMMConfiguration`` holds, in its field order: grid size, the
    transition and observation band widths, the transition and observation
    sigmas."""
    n, k_trans, k_obs, s_trans, s_obs = numbers
    return DiscreteHMMConfiguration(int(n), int(k_trans), int(k_obs), float(s_trans), float(s_obs))


def ppca_params_from_numpy(W: np.ndarray, mu: np.ndarray, sigma, device="cpu"):
    """PPCA's ``(W, mu, sigma)`` as float32 tensors on ``device`` (``sigma``
    a 0-dim tensor)."""
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device) for a in (W, mu, sigma))
