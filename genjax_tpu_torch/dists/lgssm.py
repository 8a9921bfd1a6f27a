"""``LinearGaussianSSM``: the exact posterior over the latent path of a
linear-Gaussian state-space model, and the Kalman family it rests on.

Counterpart of ``genjax_tpu/dists/lgssm.py``: Kalman filtering (sequential
and temporally parallel), RTS smoothing (both), forward-filtering
backward-sampling, forecasting, EM for the parameters, the exact path
densities, and ``LinearGaussianSSM``, a ``Distribution`` whose
``random_weighted`` draws a whole latent path from the true posterior with
its exact density: the log-marginal oracle for the particle filters.

Model: ``z_0 ~ N(mu0, P0)``, ``z_t = A z_{t-1} + w_t`` with ``w_t ~ N(0,
Q)``, ``y_t = C z_t + v_t`` with ``v_t ~ N(0, R)``, observations ``t = 0 ..
T-1`` of ``z_t``. Every function runs where its ``ys`` and parameters live,
in their dtype. The sequential passes are Python loops of small dense
matrix products; the parallel ones compose their elements by a log-depth
inclusive scan written in plain tensor ops (``core/scan.py``), where the
reference calls ``lax.associative_scan``. A matrix that is not positive
definite gives NaN, as ``jnp.linalg.cholesky`` does.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..core import keys
from ..core.pytree import Pytree
from ..core.scan import associative_scan, reverse_scan
from ..generative.mask import Mask
from .catalog import cholesky_or_nan
from .distribution import Distribution

_LOG_2PI = math.log(2.0 * math.pi)


@Pytree.dataclass
class LGSSMParams(Pytree):
    """Dense LGSSM parameters."""

    A: Any  # (Dz, Dz) transition
    Q: Any  # (Dz, Dz) transition noise covariance
    C: Any  # (Dy, Dz) observation matrix
    R: Any  # (Dy, Dy) observation noise covariance
    mu0: Any  # (Dz,) initial mean
    P0: Any  # (Dz, Dz) initial covariance

    @staticmethod
    def scalar(a, q, c=1.0, r=1.0, mu0=0.0, p0=None) -> "LGSSMParams":
        """The 1-D system from scalar coefficients (float32, on the CPU);
        ``q``, ``r`` and ``p0`` are VARIANCES, ``p0`` ``q`` by default."""

        def one(v):
            return torch.as_tensor(v, dtype=torch.float32).reshape(1, 1)

        return LGSSMParams(
            A=one(a), Q=one(q), C=one(c), R=one(r),
            mu0=torch.as_tensor(mu0, dtype=torch.float32).reshape(1),
            P0=one(q if p0 is None else p0),
        )


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product over leading batch axes."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _mvn_logpdf(x, mean, cov) -> torch.Tensor:
    d = x.shape[-1]
    chol = cholesky_or_nan(cov)
    a = torch.linalg.solve_triangular(chol, (x - mean).unsqueeze(-1), upper=False).squeeze(-1)
    log_det = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * torch.sum(a * a, dim=-1) - log_det - 0.5 * d * _LOG_2PI


def kalman_update(mean_pred, cov_pred, C, R, y):
    """One measurement update: ``(mean_f, cov_f, ll)`` with ``ll`` the exact
    predictive density ``log p(y | pred)``."""
    s = C @ cov_pred @ C.T + R
    resid = y - C @ mean_pred
    ll = _mvn_logpdf(resid, torch.zeros_like(resid), s)
    gain = torch.linalg.solve(s, C @ cov_pred).T
    return mean_pred + gain @ resid, cov_pred - gain @ s @ gain.T, ll


def kalman_filter(params: LGSSMParams, ys):
    """The forward pass over ``ys (T, Dy)``: ``(filtered_means (T, Dz),
    filtered_covs (T, Dz, Dz), log_marginal)``, the last the exact ``log
    p(y_{0:T-1})``."""
    A, Q, C, R = params.A, params.Q, params.C, params.R
    mean_pred, cov_pred = params.mu0, params.P0
    means, covs, lls = [], [], []
    for y in ys:
        mean_f, cov_f, ll = kalman_update(mean_pred, cov_pred, C, R, y)
        means.append(mean_f)
        covs.append(cov_f)
        lls.append(ll)
        mean_pred, cov_pred = A @ mean_f, A @ cov_f @ A.T + Q
    return torch.stack(means), torch.stack(covs), torch.stack(lls).sum()


def kalman_filter_parallel(params: LGSSMParams, ys):
    """Temporally parallel filtering (Särkkä & García-Fernández 2021): each
    step is a five-matrix element ``(A, b, C, eta, J)`` whose composition
    is associative, so the filter takes O(log T) depth of batched (Dz, Dz)
    products and solves. Returns ``(filtered_means, filtered_covs)``, those
    of :func:`kalman_filter` up to rounding."""
    A, Q, C, R = params.A, params.Q, params.C, params.R
    dz = params.mu0.shape[0]
    I = torch.eye(dz, dtype=A.dtype, device=A.device)
    S = C @ Q @ C.T + R
    K = torch.linalg.solve(S, C @ Q).T  # Q C^T S^-1
    HtSi = torch.linalg.solve(S, C).T  # C^T S^-1
    m = ys.shape[0] - 1

    def const(M):
        return M.expand((m,) + tuple(M.shape))

    rest = (
        const((I - K @ C) @ A),
        ys[1:] @ K.T,
        const((I - K @ C) @ Q),
        ys[1:] @ (A.T @ HtSi).T,
        const(A.T @ HtSi @ C @ A),
    )
    S0 = C @ params.P0 @ C.T + R
    K0 = torch.linalg.solve(S0, C @ params.P0).T
    first = (
        torch.zeros((dz, dz), dtype=A.dtype, device=A.device),
        params.mu0 + K0 @ (ys[0] - C @ params.mu0),
        params.P0 - K0 @ C @ params.P0,
        torch.zeros(dz, dtype=A.dtype, device=A.device),
        torch.zeros((dz, dz), dtype=A.dtype, device=A.device),
    )
    elems = tuple(torch.cat([f[None], r], dim=0) for f, r in zip(first, rest))

    def combine(e_i, e_j):
        A_i, b_i, C_i, eta_i, J_i = e_i
        A_j, b_j, C_j, eta_j, J_j = e_j
        G = torch.linalg.solve((I + C_i @ J_j).mT, A_j.mT).mT  # A_j (I + C_i J_j)^-1
        E = torch.linalg.solve((I + J_j @ C_i).mT, A_i).mT  # A_i^T (I + J_j C_i)^-1
        return (
            G @ A_i,
            _mv(G, b_i + _mv(C_i, eta_j)) + b_j,
            G @ C_i @ A_j.mT + C_j,
            _mv(E, eta_j - _mv(J_j, b_i)) + eta_i,
            E @ J_j @ A_i + J_i,
        )

    _, means, covs, _, _ = associative_scan(combine, elems)
    return means, covs


def kalman_smoother_parallel(params: LGSSMParams, ys):
    """Temporally parallel RTS smoothing: the backward conditionals
    ``x_k | x_{k+1}, y_{0:k} ~ N(E_k x_{k+1} + g_k, L_k)`` compose
    associatively, so after a parallel filtering pass the smoothed
    marginals come from one reversed scan. Returns ``(smoothed_means,
    smoothed_covs)``, those of :func:`kalman_smoother` up to rounding."""
    A, Q = params.A, params.Q
    means_f, covs_f = kalman_filter_parallel(params, ys)
    m_f, P_f = means_f[:-1], covs_f[:-1]
    cov_pred = A @ P_f @ A.T + Q
    E = torch.linalg.solve(cov_pred, A @ P_f).mT  # P_f A^T cov_pred^-1
    g = m_f - _mv(E @ A, m_f)
    L = P_f - E @ A @ P_f
    dz = params.mu0.shape[0]
    last = (torch.zeros((dz, dz), dtype=A.dtype, device=A.device), means_f[-1], covs_f[-1])
    elems = tuple(torch.cat([r, f[None]], dim=0) for r, f in zip((E, g, L), last))

    def combine(a, b):
        E_a, g_a, L_a = a
        E_b, g_b, L_b = b
        return E_a @ E_b, _mv(E_a, g_b) + g_a, E_a @ L_b @ E_a.mT + L_a

    # the ordered suffix composition elem_k * ... * elem_{T-1}: the operands
    # swap in the reversed scan
    _, means_s, covs_s = reverse_scan(lambda a, b: combine(b, a), elems)
    return means_s, covs_s


def _smoother_with_lag1(params: LGSSMParams, ys):
    """RTS smoothing and the lag-one smoothed cross-covariances
    ``cov(z_{t+1}, z_t | y)`` that the EM M-step needs."""
    A, Q = params.A, params.Q
    means_f, covs_f, log_marginal = kalman_filter(params, ys)
    mean_next, cov_next = means_f[-1], covs_f[-1]
    means_s, covs_s, lag1 = [mean_next], [cov_next], []
    for t in range(ys.shape[0] - 2, -1, -1):
        mean_f, cov_f = means_f[t], covs_f[t]
        cov_pred = A @ cov_f @ A.T + Q
        gain = torch.linalg.solve(cov_pred, A @ cov_f).T  # J_t
        mean_s = mean_f + gain @ (mean_next - A @ mean_f)
        cov_s = cov_f + gain @ (cov_next - cov_pred) @ gain.T
        lag1.append(cov_next @ gain.T)  # P_{t+1|T} J_t^T
        means_s.append(mean_s)
        covs_s.append(cov_s)
        mean_next, cov_next = mean_s, cov_s
    dz = params.mu0.shape[0]
    lag = torch.stack(lag1[::-1]) if lag1 else torch.zeros((0, dz, dz), dtype=A.dtype, device=A.device)
    return torch.stack(means_s[::-1]), torch.stack(covs_s[::-1]), lag, log_marginal


def kalman_smoother(params: LGSSMParams, ys):
    """RTS smoothing: ``(smoothed_means, smoothed_covs, log_marginal)``."""
    means_s, covs_s, _lag1, log_marginal = _smoother_with_lag1(params, ys)
    return means_s, covs_s, log_marginal


def ffbs(gen: torch.Generator, params: LGSSMParams, ys):
    """Forward-filtering backward-sampling: one exact joint draw ``z_{0:T-1}
    ~ p(z | y)``. Returns ``(zs (T, Dz), log_marginal)``. Under a key the
    last state draws under ``split(key)[0]`` and state ``t`` under
    ``split(split(key)[1], T - 1)[t]``, as the reference's reverse scan
    does; a generator is drawn from in sequence."""
    A, Q = params.A, params.Q
    means_f, covs_f, log_marginal = kalman_filter(params, ys)
    T = ys.shape[0]
    if keys.is_key(gen):
        k_last, k_rest = keys.split(gen).unbind(-2)
        step_keys = keys.split(k_rest, T - 1).unbind(-2) if T > 1 else ()
        streams = list(step_keys) + [k_last]
    else:
        streams = [gen] * T

    def draw(g, mean, cov):
        if keys.is_key(g):
            z = keys.normal(g, mean.shape).to(mean.dtype)
        else:
            z = torch.randn(mean.shape, generator=g, device=g.device, dtype=mean.dtype)
        return mean + cholesky_or_nan(cov) @ z

    z_next = draw(streams[-1], means_f[-1], covs_f[-1])
    zs = [z_next]
    for t in range(T - 2, -1, -1):
        mean_f, cov_f = means_f[t], covs_f[t]
        cov_pred = A @ cov_f @ A.T + Q
        gain = torch.linalg.solve(cov_pred, A @ cov_f).T
        mean_c = mean_f + gain @ (z_next - A @ mean_f)
        cov_c = cov_f - gain @ A @ cov_f
        z_next = draw(streams[t], mean_c, 0.5 * (cov_c + cov_c.T))  # symmetrised for the factor
        zs.append(z_next)
    return torch.stack(zs[::-1]), log_marginal


def kalman_predict(params: LGSSMParams, ys, horizon: int):
    """Exact forecasts after assimilating ``ys``: ``(z_means (h, Dz), z_covs
    (h, Dz, Dz), y_means (h, Dy), y_covs (h, Dy, Dy))``, the laws of
    ``z_{T-1+k}, y_{T-1+k} | y_{0:T-1}`` for ``k = 1 .. horizon``."""
    A, Q, C, R = params.A, params.Q, params.C, params.R
    means_f, covs_f, _ = kalman_filter(params, ys)
    mean, cov = means_f[-1], covs_f[-1]
    out = []
    for _ in range(horizon):
        mean, cov = A @ mean, A @ cov @ A.T + Q
        out.append((mean, cov, C @ mean, C @ cov @ C.T + R))
    return tuple(torch.stack(parts) for parts in zip(*out))


def lgssm_em(params: LGSSMParams, ys, *, n_iters: int = 20, fit: tuple = ("A", "Q", "C", "R")):
    """EM (Shumway & Stoffer 1982) for the LGSSM's parameters: each
    iteration one smoothing pass (E-step) and the closed-form updates of the
    matrices in ``fit`` (M-step). ``mu0`` and ``P0`` stay fixed. Returns
    ``(fitted_params, log_marginals (n_iters,))``, the log marginal of each
    iteration's parameters before its update."""
    ys = torch.as_tensor(ys)
    T = ys.shape[0]

    def sym(m):
        return 0.5 * (m + m.T)

    p, lms = params, []
    for _ in range(n_iters):
        means_s, covs_s, lag1, lm = _smoother_with_lag1(p, ys)
        ezz = covs_s + means_s[:, :, None] * means_s[:, None, :]  # E[z_t z_t^T | y]
        ezz1 = lag1 + means_s[1:, :, None] * means_s[:-1, None, :]  # E[z_{t+1} z_t^T | y]
        s00, s11, s10 = ezz[:-1].sum(0), ezz[1:].sum(0), ezz1.sum(0)
        A_new = torch.linalg.solve(s00.T, s10.T).T if "A" in fit else p.A
        if "Q" in fit:
            Q_new = (s11 - A_new @ s10.T - s10 @ A_new.T + A_new @ s00 @ A_new.T) / (T - 1)
        else:
            Q_new = p.Q
        syz = torch.einsum("ti,tj->ij", ys, means_s)
        szz = ezz.sum(0)
        C_new = torch.linalg.solve(szz.T, syz.T).T if "C" in fit else p.C
        if "R" in fit:
            resid = ys - means_s @ C_new.T
            R_new = (torch.einsum("ti,tj->ij", resid, resid) + C_new @ covs_s.sum(0) @ C_new.T) / T
        else:
            R_new = p.R
        p = LGSSMParams(A=A_new, Q=sym(Q_new), C=C_new, R=sym(R_new), mu0=p.mu0, P0=p.P0)
        lms.append(lm)
    return p, torch.stack(lms)


def path_log_joint(params: LGSSMParams, zs, ys):
    """Exact ``log p(z_{0:T-1}, y_{0:T-1})``."""
    A, Q, C, R = params.A, params.Q, params.C, params.R
    lp = _mvn_logpdf(zs[0], params.mu0, params.P0)
    trans = _mvn_logpdf(zs[1:], zs[:-1] @ A.T, Q)
    obs = _mvn_logpdf(ys, zs @ C.T, R)
    return lp + trans.sum() + obs.sum()


def exact_path_log_posterior(params: LGSSMParams, zs, ys, log_marginal=None):
    """``log p(z | y) = log p(z, y) - log p(y)``, exactly."""
    if log_marginal is None:
        _, _, log_marginal = kalman_filter(params, ys)
    return path_log_joint(params, zs, ys) - log_marginal


@Pytree.dataclass
class _LGSSMLatentPathPosterior(Distribution):
    """Exact sampling and density of LGSSM latent paths given their
    observations. Arguments: ``(params, ys)``."""

    def random_weighted(self, gen: torch.Generator, *args):
        params, ys = args
        zs, log_marginal = ffbs(gen, params, ys)
        return exact_path_log_posterior(params, zs, ys, log_marginal), zs

    def estimate_logpdf(self, gen, v, *args):
        params, ys = args
        return exact_path_log_posterior(params, v, ys)

    def assess(self, chm, args):
        v = chm.get_value()
        if isinstance(v, Mask):
            v = v.value
        params, ys = args
        return exact_path_log_posterior(params, v, ys), v

    def data_logpdf(self, params: LGSSMParams, ys):
        """Exact ``log p(y_{0:T-1})``."""
        return kalman_filter(params, ys)[2]


LinearGaussianSSM = _LGSSMLatentPathPosterior()
