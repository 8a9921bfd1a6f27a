"""Bayesian regression families.

Counterpart of ``genjax_tpu/models/regression.py``: ``linear_regression``,
the flagship ``hierarchical_regression``, ``logistic_regression`` and
``poisson_regression``. ``X`` is taken as an array
(numpy, as the reference's benchmark passes it) and used as a float32
tensor on the device of the model's draws.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from ..core.handlers import active_handler
from ..core.pytree import Pytree
from ..dists import flip, log_normal, mv_normal_diag, poisson
from ..generative.trace import trace_device
from ..lang.static_lang import StaticGenerativeFunction, gen


def _on_device(array) -> Callable[[torch.device], torch.Tensor]:
    """``array`` as a float32 tensor, copied once to each device asked for."""
    host = torch.as_tensor(np.asarray(array, np.float32))
    return functools.cache(lambda device: host.to(device))


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _running_device() -> torch.device:
    """The device that the running model body was called on: its
    generator's, or in ``assess`` (no generator) its choices'. A model whose
    first draw has tensor parameters makes them here, so that its traces
    hold their leaves on one device."""
    handler = active_handler()
    gen = getattr(handler, "gen", None)
    if gen is not None:
        return gen.device
    return trace_device(getattr(handler, "chm", None)) or torch.device("cpu")


@Pytree.dataclass
class RegressionModel(StaticGenerativeFunction):
    """A ``@gen`` regression model that also declares, as plain data, its
    family and constants, so that code which knows the family can recognise
    the model's density (the CUDA HMC sweep's device bodies in
    ``kernels/bodies.py``)."""

    column_family: str = Pytree.static(default="")
    X: np.ndarray = Pytree.static(default=None, compare=False)
    obs_scale: float = Pytree.static(default=0.0)


def linear_regression(X, *, obs_scale: float = 0.25, prior_scale: float = 1.0):
    """``w ~ N(0, prior_scale); y ~ N(X @ w, obs_scale)``.

    Returns ``(model, exact_posterior)`` where ``exact_posterior(y)`` gives
    the conjugate ``(mean, covariance)`` of ``w | y``.
    """
    X_on = _on_device(X)
    n, d = np.shape(X)

    @gen
    def model():
        dev = _running_device()
        w = mv_normal_diag(torch.zeros(d, device=dev), prior_scale * torch.ones(d, device=dev)) @ "w"
        return mv_normal_diag(X_on(dev) @ w, obs_scale * torch.ones(n, device=dev)) @ "y"

    def exact_posterior(y):
        Xt = X_on(torch.device("cpu"))
        y = torch.as_tensor(np.asarray(y, np.float32))
        prec = torch.eye(d) / prior_scale**2 + (Xt.T @ Xt) / obs_scale**2
        cov = torch.linalg.inv(prec)
        mean = cov @ (Xt.T @ y) / obs_scale**2
        return mean, cov

    return model, exact_posterior


def hierarchical_regression(X, *, obs_scale: float = 0.25):
    """The flagship model: ``tau ~ LogNormal(0, 0.5)``, ``w ~ N(0, tau)``,
    ``y ~ N(X @ w, obs_scale)``. Addresses: ``tau``, ``w``, ``y``.

    The model declares its family, ``X`` and ``obs_scale``: packed over
    exactly ``["tau", "w"]`` with exactly ``y`` constrained, its column
    log-density carries the ``hier_regression`` device body.
    """
    X_on = _on_device(X)
    n, d = np.shape(X)

    def model():
        tau = log_normal(0.0, 0.5) @ "tau"
        dev = _device_of(tau)
        w = mv_normal_diag(torch.zeros(d, device=dev), tau * torch.ones(d, device=dev)) @ "w"
        return mv_normal_diag(X_on(dev) @ w, obs_scale * torch.ones(n, device=dev)) @ "y"

    return RegressionModel(
        gen(model).source, "hierarchical_regression", np.asarray(X, np.float32), float(obs_scale)
    )


def logistic_regression(X, *, prior_scale: float = 2.0):
    """Bayesian logistic regression: ``w ~ N(0, prior_scale)``, ``y_i ~
    Bernoulli(sigmoid(x_i . w))``. Addresses ``"w"`` and ``("obs", i,
    "y")``, one flip a point through a vmapped observation model; constrain
    with ``C["obs", :, "y"].set(y01)``. Returns ``model``."""
    X_on = _on_device(X)
    n, d = np.shape(X)

    # made once, outside the body, so that every run of the body calls the
    # same generative function
    @gen
    def obs_point(i, probs):
        return flip(probs[i]) @ "y"

    obs_vmap = obs_point.vmap(in_axes=(0, None))

    @gen
    def model():
        dev = _running_device()
        w = mv_normal_diag(torch.zeros(d, device=dev), prior_scale * torch.ones(d, device=dev)) @ "w"
        probs = torch.sigmoid(X_on(dev) @ w)
        _ = obs_vmap(torch.arange(n, device=dev), probs) @ "obs"
        return probs

    return model


def poisson_regression(X, *, prior_scale: float = 1.0):
    """Poisson GLM: ``w ~ N(0, prior_scale)``, ``y_i ~ Poisson(exp(x_i .
    w))``. Addresses ``"w"`` and ``("obs", i, "y")``; constrain with
    ``C["obs", :, "y"].set(counts)``. Returns ``model``: the log-posterior
    is strictly concave, so ``laplace_approximation`` is its validation
    reference."""
    X_on = _on_device(X)
    n, d = np.shape(X)

    # made once, outside the body (see logistic_regression)
    @gen
    def obs_point(i, rates):
        return poisson(rates[i]) @ "y"

    obs_vmap = obs_point.vmap(in_axes=(0, None))

    @gen
    def model():
        dev = _running_device()
        w = mv_normal_diag(torch.zeros(d, device=dev), prior_scale * torch.ones(d, device=dev)) @ "w"
        rates = torch.exp(X_on(dev) @ w)
        _ = obs_vmap(torch.arange(n, device=dev), rates) @ "obs"
        return rates

    return model
