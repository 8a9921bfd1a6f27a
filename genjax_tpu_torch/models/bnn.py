"""The Bayesian neural network regression family.

Counterpart of ``genjax_tpu/models/bnn.py``: the posterior is over every
weight and bias of an MLP, the likelihood a chain of matmuls, and the
flattened weight vector what ``ColumnPacker`` packs. ``hidden=()``
collapses the network to a conjugate Bayesian linear regression with an
exact posterior (``bnn_exact_linear_posterior``); ``bnn_predict`` turns
weight draws into a posterior predictive mean and sd. Weight priors are
``N(0, prior_scale / sqrt(fan_in))``. ``X`` is used on the device of the
model's draws.

>>> import torch
>>> X = torch.randn(6, 2, generator=torch.Generator().manual_seed(0))
>>> model, addresses, forward = bayesian_nn(X, hidden=(4,))
>>> tr = model.simulate(torch.Generator().manual_seed(1), ())
>>> addresses, tuple(forward(tr.get_choices(), X).shape)
(['W0', 'b0', 'W1', 'b1'], (6, 1))
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch

from ..dists import mv_normal_diag
from ..generative.mask import Mask
from ..lang.static_lang import gen
from .regression import _running_device

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": functools.partial(torch.nn.functional.gelu, approximate="tanh"),
    "linear": lambda x: x,
}


def _layer_dims(d_in: int, hidden: Sequence[int], d_out: int):
    dims = [d_in, *hidden, d_out]
    return list(zip(dims[:-1], dims[1:]))


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def bayesian_nn(
    X,
    *,
    hidden: Sequence[int] = (8,),
    d_out: int = 1,
    activation: str = "tanh",
    prior_scale: float = 1.0,
    obs_scale: float = 0.25,
):
    """MLP regression with every weight and bias a latent address.

    Addresses ``"W0", "b0", "W1", "b1", ...`` (flattened vectors, reshaped
    in the body), observation ``"y"`` of shape ``(n * d_out,)``. Returns
    ``(model, weight_addresses, forward)``, ``forward(chm, X)`` the network
    at the weights a choice map holds (draws ride a leading batch axis under
    ``torch.func.vmap``)."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(_ACTIVATIONS)}, got {activation!r}")
    act = _ACTIVATIONS[activation]
    X_host = _f32(X)
    n, d_in = X_host.shape
    layers = _layer_dims(d_in, hidden, d_out)
    addresses = [f"{p}{i}" for i in range(len(layers)) for p in ("W", "b")]
    w_scales = [prior_scale / math.sqrt(fan_in) for fan_in, _ in layers]
    X_on = functools.cache(lambda dev: X_host.to(dev))

    @gen
    def model():
        dev = _running_device()
        h = X_on(dev)
        for i, (fan_in, fan_out) in enumerate(layers):
            w_flat = mv_normal_diag(torch.zeros(fan_in * fan_out, device=dev),
                                    w_scales[i] * torch.ones(fan_in * fan_out, device=dev)) @ f"W{i}"
            b = mv_normal_diag(torch.zeros(fan_out, device=dev), prior_scale * torch.ones(fan_out, device=dev)) @ f"b{i}"
            h = h @ w_flat.reshape(fan_in, fan_out) + b
            if i < len(layers) - 1:
                h = act(h)
        return mv_normal_diag(h.reshape(-1), obs_scale * torch.ones(n * d_out, device=dev)) @ "y"

    def forward(chm, X_new):
        """The network's output ``(n_new, d_out)`` at the weights in ``chm``
        (a choice map holding the ``W*``/``b*`` addresses)."""

        def get(addr):
            v = chm.get_submap(addr).get_value()
            return v.value if isinstance(v, Mask) else v

        h = _f32(X_new, get("W0").device)
        for i, (fan_in, fan_out) in enumerate(layers):
            h = h @ get(f"W{i}").reshape(fan_in, fan_out) + get(f"b{i}")
            if i < len(layers) - 1:
                h = act(h)
        return h

    return model, addresses, forward


def bnn_exact_linear_posterior(X, y, *, prior_scale=1.0, obs_scale=0.25):
    """The closed-form posterior of the ``hidden=()`` (linear) network over
    the stacked ``[W0_flat, b0]`` vector: conjugate Gaussian regression with
    the model's scaled prior. Returns ``(mean, cov)`` over ``(d_in * d_out +
    d_out,)``, where ``X`` lives."""
    X = _f32(X)
    y = _f32(y, X.device).reshape(-1)
    n, d_in = X.shape
    if y.shape[0] // n != 1:
        raise NotImplementedError("exact linear posterior implemented for d_out=1")
    # the design over [W0 (d_in), b0 (1)], each block with its prior scale
    A = torch.cat([X, torch.ones((n, 1), device=X.device)], dim=1)
    prior_sd = torch.cat([torch.full((d_in,), prior_scale / math.sqrt(d_in), device=X.device),
                          torch.full((1,), float(prior_scale), device=X.device)])
    cov = torch.linalg.inv(torch.diag(1.0 / prior_sd**2) + (A.T @ A) / obs_scale**2)
    return cov @ (A.T @ y) / obs_scale**2, cov


def bnn_predict(chm_draws, X_new, forward):
    """The posterior predictive mean and sd of the network's output over a
    batch of weight draws (a leading axis on every leaf, as
    ``ADVIPosterior.sample_choices`` or vmapped trace choices give), one
    ``torch.func.vmap`` over the draws."""
    outs = torch.func.vmap(lambda c: forward(c, X_new))(chm_draws)
    return outs.mean(dim=0), outs.std(dim=0, unbiased=False)
