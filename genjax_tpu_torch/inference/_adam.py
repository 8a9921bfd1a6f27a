"""Adam on pytrees of tensors, with ``optax.adam``'s update and defaults
(``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8``, ``eps_root = 0``): the
moments, their bias corrections at step ``t`` computed in float32, and
``-lr * m_hat / (sqrt(v_hat + eps_root) + eps)``. ``learning_rate`` is a
number or a schedule ``step -> rate`` (the step counted from 0, as optax
counts). The VI driver, MAP and ADVI share it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def adam_init(params) -> AdamState:
    zeros = pytree.tree_map(torch.zeros_like, params)
    return AdamState(0, zeros, pytree.tree_map(torch.zeros_like, params))


def adam_update(grads, state: AdamState, params, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """One Adam step: ``(new_params, new_state)``."""
    lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
    count = state.count + 1
    mu = pytree.tree_map(lambda g, m: (1.0 - b1) * g + b1 * m, grads, state.mu)
    nu = pytree.tree_map(lambda g, v: (1.0 - b2) * g * g + b2 * v, grads, state.nu)
    # float32 numbers on the host: nothing is copied to the card
    c1 = float(np.float32(1.0) - np.float32(b1) ** count)
    c2 = float(np.float32(1.0) - np.float32(b2) ** count)

    def step(p, m, v):
        m_hat = m / c1
        v_hat = v / c2
        return p + (-lr) * (m_hat / (torch.sqrt(v_hat + eps_root) + eps))

    return pytree.tree_map(step, params, mu, nu), AdamState(count, mu, nu)
