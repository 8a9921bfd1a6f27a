"""Discrete HMM model families, paired with the exact machinery of
``dists.discrete_hmm`` and ``dists.hmm_tools``.

Counterpart of ``genjax_tpu/models/hmm.py``: ``discrete_hmm_model`` (the
scanned Markov chain of a ``DiscreteHMMConfiguration``) and
``dense_hmm_model`` (any dense HMM). The tables are made on the device of
the model's draws, once per device.

>>> import torch
>>> import genjax_tpu_torch as g
>>> from genjax_tpu_torch.dists import DiscreteHMMConfiguration
>>> chain, cfg = discrete_hmm_model(DiscreteHMMConfiguration(4, 1, 1, 0.5, 0.5), 5)
>>> tr = chain.simulate(torch.Generator().manual_seed(0), (torch.tensor(2), torch.zeros(5)))
>>> tuple(tr.get_choices()[:, "z"].shape), tuple(tr.get_choices()[:, "x"].shape)
((5,), (5,))
"""

from __future__ import annotations

import functools

import torch

from ..combinators.scan import ScanCombinator
from ..dists import categorical
from ..dists.discrete_hmm import DiscreteHMMConfiguration
from ..lang.static_lang import gen
from .regression import _running_device


def discrete_hmm_model(config: DiscreteHMMConfiguration, max_length: int):
    """The scanned Markov chain whose exact posterior ``DiscreteHMM``
    computes: addresses ``(t, "z")`` latent, ``(t, "x")`` observation.

    Returns ``(chain, config)``; run it from carry ``config.linear_grid_dim
    // 2``, the exact machinery's initial state."""
    transition = functools.cache(config.transition_tensor)
    observation = functools.cache(config.observation_tensor)

    @gen
    def kernel(state, _x):
        dev = _running_device()
        z = categorical(transition(dev)[state, :]) @ "z"
        _ = categorical(observation(dev)[z, :]) @ "x"
        return (z, None)

    return ScanCombinator(kernel, length=max_length), config


def dense_hmm_model(log_pi, log_trans, log_obs, length: int):
    """A scanned ``@gen`` model of an arbitrary dense HMM in the
    ``dists.hmm_tools`` convention: the first latent draws from ``log_pi``
    (carry ``-1`` selects it), then transitions. Addresses ``(t, "z")``
    latent and ``(t, "y")`` observation; constrain with ``C[:,
    "y"].set(ys)`` and run from carry ``-1`` with ``xs`` of length
    ``length``."""
    # row -1 of the stacked table is the initial distribution
    host = torch.cat([torch.as_tensor(log_trans), torch.as_tensor(log_pi)[None]], dim=0)
    obs_host = torch.as_tensor(log_obs)
    table = functools.cache(lambda dev: host.to(dev))
    obs = functools.cache(lambda dev: obs_host.to(dev))

    @gen
    def kernel(state, _x):
        dev = _running_device()
        z = categorical(table(dev)[state, :]) @ "z"
        y = categorical(obs(dev)[z, :]) @ "y"
        return (z, y)

    return ScanCombinator(kernel, length=length)
