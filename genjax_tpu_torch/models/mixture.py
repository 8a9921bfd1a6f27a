"""Mixture models: a finite Gaussian mixture and a truncated
stick-breaking Dirichlet-process mixture over scalar data.

Counterpart of ``genjax_tpu/models/mixture.py``. The observation model of
a point is one ``@gen`` made once per model, outside its body (the
reference makes it inside), so that every run of the body calls the same
generative function and two traces of the model have one structure.
Constants are made on the device of the model's draws.
"""

from __future__ import annotations

import torch

from ..dists import beta as beta_dist
from ..dists import categorical, mv_normal_diag, normal
from ..lang.static_lang import gen
from .regression import _running_device


def _obs_point(obs_scale: float):
    @gen
    def obs_point(i, logits, means):
        z = categorical(logits) @ "z"
        return normal(means[z], obs_scale) @ "x"

    return obs_point.vmap(in_axes=(0, None, None))


def gaussian_mixture_model(k: int, *, obs_scale: float = 0.5, mean_scale: float = 3.0):
    """A finite Gaussian mixture: ``logits`` and the cluster ``means`` are
    latent, each point draws its cluster ``("obs", i, "z")`` and its value
    ``("obs", i, "x")``. Returns ``model(data)``."""
    obs = _obs_point(obs_scale)

    @gen
    def model(data):
        dev = _running_device()
        logits = mv_normal_diag(torch.zeros(k, device=dev), torch.ones(k, device=dev)) @ "logits"
        means = mv_normal_diag(torch.zeros(k, device=dev), mean_scale * torch.ones(k, device=dev)) @ "means"
        _ = obs(torch.arange(data.shape[0], device=dev), logits, means) @ "obs"
        return means

    return model


def dp_mixture_model(
    k_trunc: int,
    *,
    alpha: float = 2.0,
    obs_scale: float = 0.5,
    mean_scale: float = 3.0,
):
    """A truncated stick-breaking Dirichlet-process mixture: the sticks
    ``beta_i``, the ``means``, and each point's ``("obs", i, "z")`` and
    ``("obs", i, "x")``. Returns ``model(data)``."""
    obs = _obs_point(obs_scale)

    @gen
    def model(data):
        dev = _running_device()
        sticks = []
        rest = torch.ones((), device=dev)
        for i in range(k_trunc - 1):
            b = beta_dist(1.0, alpha) @ f"beta_{i}"
            sticks.append(rest * b)
            rest = rest * (1.0 - b)
        weights = torch.stack([*sticks, rest])
        means = mv_normal_diag(
            torch.zeros(k_trunc, device=dev), mean_scale * torch.ones(k_trunc, device=dev)
        ) @ "means"
        _ = obs(torch.arange(data.shape[0], device=dev), torch.log(weights + 1e-37), means) @ "obs"
        return weights

    return model
