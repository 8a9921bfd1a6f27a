"""Gaussian-process regression and classification (exact conjugate answers).

Counterpart of ``genjax_tpu/models/gp.py``: the squared-exponential Gram
matrix, the ``@gen`` model ``gp_regression`` whose likelihood is the exact
GP marginal (``mv_normal`` over ``K + sigma^2 I``), the closed-form log
marginal and predictive, and the Laplace approximation for binary GP
classification with its predictive. Inputs may be numpy arrays or tensors.
The closed forms run on the card unless the caller asks for the CPU: their
inputs are placed on ``device`` (``"cuda"`` by default; with no card they
raise, naming ``device="cpu"``). ``sq_exp_kernel`` and ``gp_regression``
follow the device of their inputs and draws, as the GFI does. The latent
function values of a GP are sampled exactly by elliptical slice sampling
(``kernels/elliptical.py``), which sits above this module.
"""

from __future__ import annotations

import math

import torch

from ..core.device import entry_device
from ..dists import mv_normal, normal
from ..dists.catalog import cholesky_or_nan
from ..lang.static_lang import gen
from .regression import _device_of, _on_device


def _as_points(x) -> torch.Tensor:
    """Normalize inputs to ``(N, D)``: a 1-D array is N scalar points, not
    one N-dimensional point."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x.reshape(-1, 1) if x.ndim <= 1 else x


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def sq_exp_kernel(x1, x2, amplitude, lengthscale) -> torch.Tensor:
    """Squared-exponential Gram matrix ``amp^2 exp(-|x - x'|^2 / (2 l^2))``
    between row-sets ``x1 (N, D)`` and ``x2 (M, D)``: one matmul for the
    cross terms plus rank-1 corrections, as the reference computes it."""
    x1 = _as_points(x1)
    x2 = _as_points(x2).to(x1.device)
    sq1 = torch.sum(x1**2, dim=1)[:, None]
    sq2 = torch.sum(x2**2, dim=1)[None, :]
    d2 = sq1 + sq2 - 2.0 * (x1 @ x2.T)
    return amplitude**2 * torch.exp(-0.5 * torch.clamp(d2, min=0.0) / lengthscale**2)


def gp_regression(X, *, jitter: float = 1e-5):
    """``log_amp, log_ls, log_noise ~ N(0, 1)``; ``y ~ N(0, K + sigma^2 I)``
    with the function values marginalized exactly. Addresses: ``"log_amp"``,
    ``"log_ls"``, ``"log_noise"``, ``"y"``. ``X`` is used on the device of
    the model's draws.
    """
    points = _as_points(X).cpu()
    X_on = _on_device(points)
    n = points.shape[0]

    @gen
    def model():
        log_amp = normal(0.0, 1.0) @ "log_amp"
        log_ls = normal(0.0, 1.0) @ "log_ls"
        log_noise = normal(0.0, 1.0) @ "log_noise"
        dev = _device_of(log_amp)
        x = X_on(dev)
        K = sq_exp_kernel(x, x, torch.exp(log_amp), torch.exp(log_ls))
        cov = K + (torch.exp(2.0 * log_noise) + jitter) * torch.eye(n, device=dev)
        return mv_normal(torch.zeros(n, device=dev), cov) @ "y"

    return model


def _noisy_gram(X, amplitude, lengthscale, noise, jitter) -> torch.Tensor:
    K = sq_exp_kernel(X, X, amplitude, lengthscale)
    return K + (noise**2 + jitter) * torch.eye(K.shape[0], device=K.device)


def _on(device, entry: str, X, *more):
    """``X`` as points and ``more`` as float32 tensors, on ``device``."""
    device = entry_device(device, entry)
    return (_as_points(X).to(device), *(_f32(v, device) for v in more))


def gp_log_marginal(X, y, amplitude, lengthscale, noise, *, jitter=1e-5, device="cuda") -> torch.Tensor:
    """Exact log marginal likelihood ``log N(y | 0, K + sigma^2 I)``: one
    Cholesky factor serves the quadratic form and the log-determinant."""
    X, y = _on(device, "gp_log_marginal", X, y)
    n = X.shape[0]
    chol = cholesky_or_nan(_noisy_gram(X, amplitude, lengthscale, noise, jitter))
    alpha = torch.cholesky_solve(y[:, None], chol).squeeze(-1)
    return (
        -0.5 * (y @ alpha)
        - torch.sum(torch.log(torch.diagonal(chol)))
        - 0.5 * n * math.log(2.0 * math.pi)
    )


def gp_posterior(X, y, X_test, amplitude, lengthscale, noise, *, jitter: float = 1e-5, device="cuda"):
    """Closed-form GP predictive at ``X_test``: ``(mean, cov)`` of the
    noise-free function values ``f* | y``, with ``K`` factorized once."""
    X, y = _on(device, "gp_posterior", X, y)
    X_test = _as_points(X_test).to(X.device)
    chol = cholesky_or_nan(_noisy_gram(X, amplitude, lengthscale, noise, jitter))
    Ks = sq_exp_kernel(X_test, X, amplitude, lengthscale)
    Kss = sq_exp_kernel(X_test, X_test, amplitude, lengthscale)
    mean = Ks @ torch.cholesky_solve(y[:, None], chol).squeeze(-1)
    cov = Kss - Ks @ torch.cholesky_solve(Ks.T, chol)
    return mean, cov


def _b_factor(K, W):
    """``sqrt(W)`` and the lower Cholesky factor of ``B = I + sqrt(W) K
    sqrt(W)`` (Rasmussen & Williams 2006, eq. 3.26)."""
    sw = torch.sqrt(W)
    B = torch.eye(K.shape[0], device=K.device) + sw[:, None] * K * sw[None, :]
    return sw, cholesky_or_nan(B)


def gp_classify_laplace(
    X, y01, amplitude, lengthscale, *, jitter: float = 1e-5, n_newton: int = 20, device="cuda"
):
    """Laplace approximation for binary GP classification (Rasmussen &
    Williams 2006, Algorithm 3.1): logistic likelihood, ``n_newton`` Newton
    steps to the posterior mode of the latent values, Gaussian curvature
    around it. Returns ``(f_hat (N,), cov (N, N), log_marginal_approx)``;
    ``kernels.elliptical.ess_sweep_cols`` samples the exact latent
    posterior to audit it."""
    X, y = _on(device, "gp_classify_laplace", X, y01)
    n = X.shape[0]
    K = sq_exp_kernel(X, X, amplitude, lengthscale) + jitter * torch.eye(n, device=X.device)

    f = torch.zeros(n, device=X.device)
    for _ in range(n_newton):
        pi = torch.sigmoid(f)
        W = pi * (1.0 - pi)  # Hessian diagonal of -log lik
        sw, L = _b_factor(K, W)
        b = W * f + (y - pi)
        # (K^-1 + W)^-1 (W f + grad) through the stabilized B-form
        a = b - sw * torch.cholesky_solve((sw * (K @ b))[:, None], L).squeeze(-1)
        f = K @ a
    pi = torch.sigmoid(f)
    sw, L = _b_factor(K, pi * (1.0 - pi))
    # posterior covariance (K^-1 + W)^-1 = K - K sw B^-1 sw K
    V = torch.linalg.solve_triangular(L, sw[:, None] * K, upper=False)
    cov = K - V.T @ V
    a = torch.linalg.solve(K, f)
    log_lik = torch.sum(y * f - torch.logaddexp(torch.zeros_like(f), f))
    lml = -0.5 * (f @ a) + log_lik - torch.sum(torch.log(torch.diagonal(L)))
    return f, cov, lml


def gp_classify_predict(X, y01, X_test, amplitude, lengthscale, *, jitter: float = 1e-5, device="cuda"):
    """Predictive class probabilities at ``X_test`` under the Laplace
    approximation, with the moderation integral approximated by MacKay's
    kappa correction. Returns ``(probs, mean_star, var_star)``."""
    X, y = _on(device, "gp_classify_predict", X, y01)
    f_hat, _, _ = gp_classify_laplace(X, y, amplitude, lengthscale, jitter=jitter, device=X.device)
    X_test = _as_points(X_test).to(X.device)
    n = X.shape[0]
    K = sq_exp_kernel(X, X, amplitude, lengthscale) + jitter * torch.eye(n, device=X.device)
    Ks = sq_exp_kernel(X_test, X, amplitude, lengthscale)
    Kss_diag = amplitude**2 * torch.ones(X_test.shape[0], device=X.device)
    pi = torch.sigmoid(f_hat)
    mean_star = Ks @ (y - pi)  # RW 3.21: K_*^T (y - pi) at the mode
    sw, L = _b_factor(K, pi * (1.0 - pi))
    v = torch.linalg.solve_triangular(L, sw[:, None] * Ks.T, upper=False)
    var_star = Kss_diag - torch.sum(v * v, dim=0)
    kappa = 1.0 / torch.sqrt(1.0 + math.pi * var_star / 8.0)
    return torch.sigmoid(kappa * mean_star), mean_star, var_star
