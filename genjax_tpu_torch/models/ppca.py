"""Probabilistic PCA (Tipping & Bishop 1999), with exact answers
throughout.

Counterpart of ``genjax_tpu/models/ppca.py``:

    z ~ N(0, I_q);  x | z ~ N(W z + mu, sigma^2 I_d)
    => x ~ N(mu, W W^T + sigma^2 I_d)        (the exact marginal)

The ML solution is an eigendecomposition of the sample covariance, the
latent posterior is Gaussian, and EM has exact M-steps, so every
approximate answer can be judged against the spectral solution. Functions
run where ``X`` (or ``W``) lives; ``ppca_em``'s iterations are a Python
loop, where the reference runs ``lax.scan``.

>>> import torch
>>> X = torch.randn(200, 4, generator=torch.Generator().manual_seed(0))
>>> W, mu, s2 = ppca_ml(X, 2)
>>> (W_em, _, s2_em), lls = ppca_em(X, 2, n_iters=100)
>>> bool(torch.isclose(ppca_log_likelihood(X, W_em, mu, s2_em), ppca_log_likelihood(X, W, mu, s2), rtol=1e-4))
True
"""

from __future__ import annotations

import functools
import math

import torch

from ..dists import mv_normal_diag
from ..lang.static_lang import gen
from .regression import _running_device

_LOG_2PI = math.log(2.0 * math.pi)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def ppca_model(W, mu, sigma):
    """The ``@gen`` model of one observation: addresses ``"z"`` (latent,
    q-dim) and ``"x"`` (observed, d-dim); vmap or repeat it for a dataset.
    ``W``, ``mu`` (tensors or numpy arrays) and ``sigma`` are used on the
    device of the model's draws."""
    d, q = tuple(torch.as_tensor(W).shape)
    consts = functools.cache(lambda dev: (_f32(W, dev), _f32(mu, dev)))

    @gen
    def model():
        dev = _running_device()
        W_d, mu_d = consts(dev)
        z = mv_normal_diag(torch.zeros(q, device=dev), torch.ones(q, device=dev)) @ "z"
        return mv_normal_diag(W_d @ z + mu_d, sigma * torch.ones(d, device=dev)) @ "x"

    return model


def ppca_log_likelihood(X, W, mu, sigma2):
    """The exact marginal ``sum_n log N(x_n; mu, W W^T + sigma2 I)``, with one
    shared Cholesky factor."""
    X = _f32(X)
    W, mu, sigma2 = _f32(W, X.device), _f32(mu, X.device), _f32(sigma2, X.device)
    n, d = X.shape
    chol = torch.linalg.cholesky(W @ W.T + sigma2 * torch.eye(d, device=X.device))
    resid = torch.linalg.solve_triangular(chol, (X - mu).T, upper=False)  # (d, n)
    return -0.5 * torch.sum(resid**2) - n * torch.sum(torch.log(torch.diagonal(chol))) - 0.5 * n * d * _LOG_2PI


def ppca_ml(X, q: int):
    """The exact maximum-likelihood fit (Tipping & Bishop sec. 3.2): the
    eigendecomposition of the sample covariance; ``sigma2_ML`` is the mean
    discarded eigenvalue and ``W_ML = U_q (Lambda_q - sigma2 I)^{1/2}``.
    Returns ``(W, mu, sigma2)``."""
    X = _f32(X)
    n, d = X.shape
    mu = X.mean(dim=0)
    S = (X - mu).T @ (X - mu) / n
    evals, evecs = torch.linalg.eigh(S)  # ascending
    evals, evecs = torch.flip(evals, dims=(0,)), torch.flip(evecs, dims=(1,))
    sigma2 = evals[q:].mean() if q < d else torch.zeros((), device=X.device)
    W = evecs[:, :q] * torch.sqrt(torch.clamp(evals[:q] - sigma2, min=0.0))
    return W, mu, sigma2


def ppca_posterior(x, W, mu, sigma2):
    """The exact latent posterior ``z | x ~ N(M^-1 W^T (x - mu), sigma2
    M^-1)`` with ``M = W^T W + sigma2 I`` (Tipping & Bishop eq. 8). Returns
    ``(mean, cov)``."""
    W = _f32(W)
    x, mu, sigma2 = _f32(x, W.device), _f32(mu, W.device), _f32(sigma2, W.device)
    M = W.T @ W + sigma2 * torch.eye(W.shape[1], device=W.device)
    return torch.linalg.solve(M, W.T @ (x - mu)), sigma2 * torch.linalg.inv(M)


def ppca_em(X, q: int, *, n_iters: int = 50):
    """EM for PPCA (Tipping & Bishop sec. 3.3), converging to the spectral ML
    solution. Returns ``((W, mu, sigma2), log_likelihoods (n_iters,))``, each
    taken at the start of its iteration (non-decreasing)."""
    X = _f32(X)
    n, d = X.shape
    mu = X.mean(dim=0)
    Xc = X - mu
    S = Xc.T @ Xc / n
    eye_q = torch.eye(q, device=X.device)
    W = torch.eye(d, device=X.device)[:, :q] * 0.5 + 0.01
    sigma2 = torch.ones((), device=X.device)
    lls = []
    for _ in range(n_iters):
        lls.append(ppca_log_likelihood(X, W, mu, sigma2))
        M = W.T @ W + sigma2 * eye_q
        # the E-step in moment form, SW = S W; the M-step (eqs. 29-30)
        SW = S @ W
        inner = sigma2 * eye_q + torch.linalg.solve(M, W.T @ SW)
        W_new = torch.linalg.solve(inner.T, SW.T).T
        sigma2 = torch.clamp(torch.trace(S - SW @ torch.linalg.solve(M, W_new.T)) / d, min=1e-8)
        W = W_new
    return (W, mu, sigma2), torch.stack(lls)
