"""Model comparison: WAIC and PSIS-LOO (Vehtari, Gelman & Gabry 2017).

Counterpart of ``genjax_tpu/inference/model_comparison.py``: ``ELPDResult``,
``waic``, ``_gpd_fit``, ``_psis_smooth_column``, ``psis_loo`` and
``compare``. Given the pointwise log-likelihoods ``log p(y_i | theta_s)``
``(S, N)`` over posterior draws ``s`` and observations ``i``, these estimate
the expected log pointwise predictive density (elpd):

- WAIC: lppd - p_waic, with p_waic the posterior variance of the pointwise
  log-likelihood;
- PSIS-LOO: importance-sampled leave-one-out, the raw ``1 / p(y_i |
  theta)`` ratios stabilised by Pareto-smoothing their tail; the fitted
  shape k-hat of each observation is its reliability diagnostic (k-hat >
  0.7 flags it).

The reference smooths one column at a time under ``vmap``. Here the whole
``(S, N)`` matrix is smoothed at once: one stable sort along the draws (as
``jnp.argsort`` is stable), the tail a slice of rows, the Zhang & Stephens
(2009) profile grid broadcast over the columns, and the smoothed values put
back by a scatter. Everything runs where the log-likelihoods live.

``waic`` and ``psis_loo`` compute in float64 whatever the input's precision
and return the input's dtype. In float32 the tail's exceedances ``exp(tail)
- exp(cutoff)`` are differences of numbers near 1, and ``p_eff`` a sum of
``N`` small differences: on an H100, at ``(S, N) = (4000, 10000)``, float32
put ``p_eff`` 0.4% and a k-hat 0.1% off the float64 result (``chip_smoke.py``'s
``[model comparison]``); in float64 they agree to rounding.

>>> import torch
>>> from genjax_tpu_torch.inference import psis_loo, waic
>>> mus = 0.5 + 0.3 * torch.randn(400, 1, generator=torch.Generator().manual_seed(0))
>>> ys = torch.tensor([0.1, 0.7, 0.4, 1.0, 0.3, 0.6])
>>> ll = -0.5 * (ys - mus) ** 2 - 0.9189   # log N(y_i; mu_s, 1), (S, N)
>>> res = psis_loo(ll)
>>> tuple(res.pointwise.shape), tuple(res.pareto_k.shape)
((6,), (6,))
>>> bool(abs(float(res.elpd) - float(waic(ll).elpd)) < 0.1)
True
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..core.pytree import Pytree


@Pytree.dataclass
class ELPDResult(Pytree):
    """``elpd`` (summed over observations), its standard error, the
    effective number of parameters, the pointwise elpd contributions, and
    (LOO only) the Pareto k-hat of each observation."""

    elpd: Any
    se: Any
    p_eff: Any
    pointwise: Any
    pareto_k: Any


def _lppd(log_lik: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(log_lik, dim=0) - math.log(log_lik.shape[0])


def _wide(log_lik):
    """``log_lik`` as a float64 tensor, and a function casting results back
    to its dtype."""
    log_lik = torch.as_tensor(log_lik)
    dtype = log_lik.dtype if log_lik.is_floating_point() else torch.get_default_dtype()
    return log_lik.to(torch.float64), lambda v: None if v is None else v.to(dtype)


def _result(cast, **fields) -> ELPDResult:
    return ELPDResult(**{k: cast(v) for k, v in fields.items()})


def waic(log_lik) -> ELPDResult:
    """WAIC from pointwise log-likelihood draws ``(S, N)``."""
    log_lik, cast = _wide(log_lik)
    p_i = torch.var(log_lik, dim=0, correction=1)
    elpd_i = _lppd(log_lik) - p_i
    n = log_lik.shape[1]
    return _result(
        cast,
        elpd=elpd_i.sum(),
        se=torch.sqrt(n * torch.var(elpd_i, correction=1)),
        p_eff=p_i.sum(),
        pointwise=elpd_i,
        pareto_k=None,
    )


def _gpd_fit(x: torch.Tensor):
    """Zhang & Stephens (2009) profile-likelihood fit of the generalised
    Pareto shape and scale to exceedances ``x (M,)``, or to each column of
    ``x (M, N)`` (sorted ascending along the first axis, all > 0). Returns
    ``(k, sigma)`` in the convention of scipy's ``c`` (Vehtari's k-hat),
    the negative of Zhang & Stephens' k."""
    m_pts = 80  # the loo package's grid
    n = x.shape[0]
    x_star = x[(n + 1) // 4 - 1]  # the lower quartile
    jj = torch.arange(1, m_pts + 1, dtype=x.dtype, device=x.device)
    jj = jj.reshape((m_pts,) + (1,) * (x.dim() - 1))
    theta = 1.0 / x[-1] + (1.0 - torch.sqrt(m_pts / (jj - 0.5))) / (3.0 * x_star)  # (80, ...)
    k = -torch.mean(torch.log1p(-theta[:, None] * x[None]), dim=1)  # (80, ...)
    lw = n * (torch.log(theta / k) + k - 1.0)
    theta_hat = torch.sum(torch.softmax(lw, dim=0) * theta, dim=0)
    k_zs = -torch.mean(torch.log1p(-theta_hat * x), dim=0)
    return -k_zs, k_zs / theta_hat


def _psis_smooth(lw: torch.Tensor):
    """Pareto-smooth every column of the log ratios ``lw (S, N)`` (Vehtari
    et al. 2017, section 3.2): the ``m`` largest of each column replaced by
    the expected order statistics of the generalised Pareto fitted to their
    exceedances. Returns ``(smoothed lw (S, N), k_hat (N,))``."""
    s = lw.shape[0]
    m = min(int(math.ceil(3.0 * math.sqrt(s))), s // 5)
    sorted_lw, order = torch.sort(lw, dim=0, stable=True)
    cutoff_idx = s - m - 1
    cutoff = sorted_lw[cutoff_idx]
    tail = sorted_lw[cutoff_idx + 1 :]  # (m, N), the largest
    exceed = torch.clamp(torch.exp(tail) - torch.exp(cutoff), min=1e-30)
    k, sigma = _gpd_fit(exceed)
    p = ((torch.arange(1, m + 1, dtype=lw.dtype, device=lw.device) - 0.5) / m)[:, None]
    quantiles = torch.where(
        torch.abs(k) < 1e-6,
        -sigma * torch.log1p(-p),
        sigma * (torch.pow(1.0 - p, -k) - 1.0) / k,
    )
    # truncated at the largest raw ratio, as the paper does
    smoothed_tail = torch.minimum(torch.log(torch.exp(cutoff) + quantiles), sorted_lw[-1])
    new_sorted = torch.cat([sorted_lw[: cutoff_idx + 1], smoothed_tail])
    return torch.empty_like(lw).scatter_(0, order, new_sorted), k


def _psis_smooth_column(lw: torch.Tensor, s: int):
    """Pareto-smooth ONE observation's log ratios ``lw (S,)``; ``s`` is
    ``S``. Returns ``(smoothed lw, k_hat)``."""
    assert lw.shape[0] == s
    out, k = _psis_smooth(lw[:, None])
    return out[:, 0], k[0]


def psis_loo(log_lik) -> ELPDResult:
    """PSIS-LOO from pointwise log-likelihood draws ``(S, N)``. The raw LOO
    importance ratios are ``-log_lik``; each observation's tail is
    Pareto-smoothed and its k-hat reported (``pareto_k[i] > 0.7`` flags an
    unreliable contribution)."""
    log_lik, cast = _wide(log_lik)
    s, n = log_lik.shape
    if s < 25:
        # the tail needs at least ceil(3 sqrt(S)) >= 5 exceedances to fit
        raise ValueError(
            f"psis_loo needs at least 25 posterior draws, got {s}; use waic() or draw more samples"
        )
    raw_lw = -log_lik
    raw_lw = raw_lw - torch.amax(raw_lw, dim=0, keepdim=True)
    lw, ks = _psis_smooth(raw_lw)
    lw = lw - torch.logsumexp(lw, dim=0, keepdim=True)
    elpd_i = torch.logsumexp(lw + log_lik, dim=0)
    return _result(
        cast,
        elpd=elpd_i.sum(),
        se=torch.sqrt(n * torch.var(elpd_i, correction=1)),
        p_eff=torch.sum(_lppd(log_lik) - elpd_i),
        pointwise=elpd_i,
        pareto_k=ks,
    )


def compare(results: dict) -> list:
    """Rank models by elpd: ``[(name, elpd, d_elpd, d_se), ...]`` best
    first, each row's elpd difference to the best (ArviZ's sign: <= 0) and
    the standard error of that difference from the pointwise
    contributions."""
    items = sorted(results.items(), key=lambda kv: float(kv[1].elpd), reverse=True)
    best = np.asarray(items[0][1].pointwise.detach().cpu())
    rows = []
    for name, res in items:
        diff = np.asarray(res.pointwise.detach().cpu()) - best
        se = float(np.sqrt(len(diff) * diff.var(ddof=1))) if len(diff) > 1 else 0.0
        rows.append((name, float(res.elpd), float(diff.sum()), se))
    return rows


__all__ = ["ELPDResult", "compare", "psis_loo", "waic"]
