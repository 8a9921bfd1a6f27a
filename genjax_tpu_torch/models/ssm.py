"""State-space model families, as kernels for ``.scan()``.

Counterpart of ``genjax_tpu/models/ssm.py``: ``linear_gaussian_ssm`` (a
latent random walk with Gaussian emissions, and its exact log marginal by
the Kalman filter) and ``stochastic_volatility``. Each kernel is
``(carry, x) -> (carry, y)``: ``kernel.scan(n=T)`` is the model over T
steps, its choices ``[t, "z"]`` (or ``"h"``) and ``[t, "y"]``.
"""

from __future__ import annotations

import math

import torch

from ..dists import normal
from ..lang.static_lang import gen


def linear_gaussian_ssm(*, trans_scale: float = 1.0, obs_scale: float = 0.5):
    """``z_t ~ N(z_{t-1}, trans_scale)``, ``y_t ~ N(z_t, obs_scale)``.
    Returns ``(kernel, exact_log_marginal)``; ``exact_log_marginal(ys,
    init_mean=0.0)`` is the Kalman filter's ``log p(y_1..T)`` in float64,
    with ``z_0 = init_mean``.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> from genjax_tpu_torch.models import linear_gaussian_ssm
    >>> kernel, exact = linear_gaussian_ssm()
    >>> model = kernel.scan(n=3)
    >>> ys = torch.tensor([0.1, -0.2, 0.3])
    >>> tr, w = model.generate(torch.Generator().manual_seed(0), g.C[:, "y"].set(ys), (0.0, None))
    >>> tuple(tr.get_choices()[:, "z"].shape), round(exact(ys.tolist()), 4)
    ((3,), -3.3434)
    """

    @gen
    def kernel(carry, x):
        z = normal(carry, trans_scale) @ "z"
        y = normal(z, obs_scale) @ "y"
        return (z, y)

    def exact_log_marginal(ys, init_mean: float = 0.0) -> float:
        q, r = trans_scale**2, obs_scale**2
        mean, var, log_z = float(init_mean), q, 0.0
        for y in ys:
            y = float(y)
            s = var + r
            log_z += -0.5 * (math.log(2 * math.pi * s) + (y - mean) ** 2 / s)
            gain = var / s
            mean = mean + gain * (y - mean)
            var = var * (1 - gain) + q
        return log_z

    return kernel, exact_log_marginal


def stochastic_volatility(*, mu: float = -1.0, phi: float = 0.97, sigma: float = 0.15):
    """The log-volatility AR(1) ``h_t ~ N(mu + phi (h_{t-1} - mu), sigma)``
    with returns ``y_t ~ N(0, exp(h_t / 2))``, as a kernel for ``.scan()``;
    addresses ``h`` (latent) and ``y``."""

    @gen
    def kernel(carry, x):
        h = normal(mu + phi * (carry - mu), sigma) @ "h"
        y = normal(0.0, torch.exp(h / 2.0)) @ "y"
        return (h, y)

    return kernel
