"""``DiscreteHMM``: the exact posterior over the latent path of a discrete
hidden Markov model on a cyclic grid.

Counterpart of ``genjax_tpu/dists/discrete_hmm.py``: the banded-circulant
configuration (``DiscreteHMMConfiguration``), forward filtering and
backward sampling, the exact path densities, the ``DiscreteHMM``
distribution and ``forward_filtering_backward_sampling``. The forward and
backward passes are Python loops over ``T`` of ``(N,)`` and ``(N, N)``
tensor ops, where the reference runs ``lax.scan``; the configuration's
tensors are made on the device of the observations they serve (the
reference keeps them in host numpy, a TPU rule).

>>> import torch
>>> cfg = DiscreteHMMConfiguration(4, 1, 1, 0.5, 0.5)
>>> ys = torch.tensor([0, 1, 1, 2])
>>> filters, log_marginal = forward_filter(cfg, ys)
>>> tuple(filters.shape), bool(torch.isfinite(log_marginal))
((4, 4), True)
>>> zs = backward_sample(torch.Generator().manual_seed(0), cfg, filters)
>>> w, _ = exact_path_log_posterior(cfg, zs, ys, log_marginal)
>>> bool(w <= 0)
True
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pytree import Pytree
from ..generative.mask import Mask
from .catalog import categorical
from .distribution import Distribution


def _circulant(row0: np.ndarray) -> np.ndarray:
    """The circulant matrix whose first column is ``row0``."""
    n = len(row0)
    return np.stack([np.roll(row0, i) for i in range(n)], axis=0).T


def scaled_circulant(N: int, k: int, epsilon: float, delta: float) -> np.ndarray:
    """Banded-circulant logits (float64 numpy): entries decay as
    ``epsilon**distance`` within band ``k`` (cyclically), ``-delta``
    outside."""
    source = np.asarray(
        [
            epsilon ** abs(i) if i <= k else (epsilon ** abs(i - N) if i - N >= -k else -delta)
            for i in range(N)
        ],
        dtype=np.float64,
    )
    return _circulant(source)


def _logits(n: int, k: int, s: float, device) -> torch.Tensor:
    # sigma <= 0 takes delta = +inf, so out-of-band logits are -inf (one-hot
    # rows after the softmax), as the reference's corrected configuration
    # does; its own source passes -inf there, which makes every row NaN
    eps, delta = (s, 1 / s) if s > 0.0 else (-np.inf, np.inf)
    return torch.from_numpy(scaled_circulant(n, k, eps, delta)).to(torch.float32).to(device)


@Pytree.dataclass
class DiscreteHMMConfiguration(Pytree):
    """Static HMM configuration over a cyclic 1-D grid of
    ``linear_grid_dim`` states. Its tensors are float32, made on ``device``
    (the CPU by default)."""

    linear_grid_dim: int = Pytree.static()
    adjacency_distance_trans: int = Pytree.static()
    adjacency_distance_obs: int = Pytree.static()
    sigma_trans: float = Pytree.static()
    sigma_obs: float = Pytree.static()

    def transition_tensor(self, device="cpu") -> torch.Tensor:
        """``(N, N)`` transition logits, row = previous state."""
        return _logits(self.linear_grid_dim, self.adjacency_distance_trans, self.sigma_trans, device)

    def observation_tensor(self, device="cpu") -> torch.Tensor:
        """``(N, N)`` observation logits, row = latent state."""
        return _logits(self.linear_grid_dim, self.adjacency_distance_obs, self.sigma_obs, device)

    def log_initial(self, device="cpu") -> torch.Tensor:
        """``(N,)``: the grid midpoint's transition row, normalized."""
        return torch.log_softmax(self.transition_tensor(device)[self.linear_grid_dim // 2, :], dim=-1)

    def log_transition(self, device="cpu") -> torch.Tensor:
        """(N, N): row = previous state, normalized over next state."""
        return torch.log_softmax(self.transition_tensor(device), dim=-1)

    def log_observation(self, device="cpu") -> torch.Tensor:
        """(N, N): row = latent state, normalized over observation."""
        return torch.log_softmax(self.observation_tensor(device), dim=-1)


def forward_filter(config: DiscreteHMMConfiguration, observations):
    """The forward algorithm, where ``observations`` live. Returns
    ``(filters, log_marginal)``: ``filters[t] = log p(z_t | y_{1:t})``
    (shape (T, N)) and ``log_marginal = log p(y_{1:T})``."""
    dev = observations.device
    log_trans = config.log_transition(dev)
    lo = config.log_observation(dev)[:, observations].T  # (T, N): log p(y_t | z_t)
    log_pred = config.log_initial(dev)
    filters, log_norms = [], []
    for t in range(lo.shape[0]):
        log_alpha = log_pred + lo[t]
        log_norm = torch.logsumexp(log_alpha, dim=0)
        log_filt = log_alpha - log_norm
        # predict: log p(z_{t+1} | y_{1:t}) = lse_z [filt(z) + trans(z -> z')]
        log_pred = torch.logsumexp(log_filt[:, None] + log_trans, dim=0)
        filters.append(log_filt)
        log_norms.append(log_norm)
    return torch.stack(filters), torch.stack(log_norms).sum()


def backward_sample(gen: torch.Generator, config: DiscreteHMMConfiguration, filters):
    """An exact posterior latent path (int64, shape (T,)) given the forward
    filters, drawn from ``gen`` from the last step back. Runs under
    ``torch.func.vmap(..., randomness="different")`` for many paths."""
    log_trans_t = config.log_transition(filters.device).T  # row = next state
    z = categorical.sample(gen, filters[-1])
    zs = [z]
    for t in range(filters.shape[0] - 2, -1, -1):
        z = categorical.sample(gen, filters[t] + torch.index_select(log_trans_t, 0, z.reshape(1))[0])
        zs.append(z)
    return torch.stack(zs[::-1])


def path_log_joint(config: DiscreteHMMConfiguration, zs, observations):
    """``log p(z_{1:T}, y_{1:T})``: one gather per factor over the path."""
    dev = observations.device
    zs = torch.as_tensor(zs, device=dev).to(torch.int64)
    init = config.log_initial(dev)[zs[0]]
    trans = config.log_transition(dev)[zs[:-1], zs[1:]].sum()
    obs = config.log_observation(dev)[zs, observations].sum()
    return init + trans + obs


def exact_path_log_posterior(config: DiscreteHMMConfiguration, zs, observations, log_marginal=None):
    """``log p(z_{1:T} | y_{1:T})`` exactly: joint minus data marginal.
    Pass ``log_marginal`` when the forward filter already ran. Returns
    ``(log_posterior, log_marginal)``."""
    joint = path_log_joint(config, zs, observations)
    if log_marginal is None:
        _, log_marginal = forward_filter(config, observations)
    return joint - log_marginal, log_marginal


@Pytree.dataclass
class _DiscreteHMMLatentSequencePosterior(Distribution):
    """Exact sampling and exact density of HMM latent paths given their
    observations. Arguments: ``(config, observations)``."""

    def random_weighted(self, gen: torch.Generator, *args):
        config, observations = args
        filters, log_marginal = forward_filter(config, observations)
        zs = backward_sample(gen, config, filters)
        w, _ = exact_path_log_posterior(config, zs, observations, log_marginal)
        return w, zs

    def estimate_logpdf(self, gen, v, *args):
        config, observations = args
        return exact_path_log_posterior(config, v, observations)[0]

    def assess(self, chm, args):
        v = chm.get_value()
        if isinstance(v, Mask):
            v = v.value
        config, observations = args
        return exact_path_log_posterior(config, v, observations)[0], v

    def data_logpdf(self, config, observations):
        """Exact ``log p(y_{1:T})``."""
        return forward_filter(config, observations)[1]


DiscreteHMM = _DiscreteHMMLatentSequencePosterior()


def forward_filtering_backward_sampling(gen: torch.Generator, config, observations):
    """Forward filter, then draw an exact posterior path. Returns ``(gen,
    (samples, filters))``, the reference's ``(key, (samples, filters))``."""
    filters, _ = forward_filter(config, observations)
    return gen, (backward_sample(gen, config, filters), filters)
