"""SMC² (``inference/smc2.py``) against the dense-grid ground truth of
``tests/inference/test_smc2.py``: a linear-Gaussian state-space model with
an unknown transition coefficient, whose likelihood ``p(y | a)`` the Kalman
filter gives exactly, so the parameter posterior and the evidence are
quadratures on a grid.

In law, at the reference test's tolerances: the weighted posterior mean of
``a`` within 0.06 of the grid's, its SD within 35%, the log evidence within
0.6; the rejuvenation fires (the parameter ESS falls below 90% once) and
accepts more than 5%; and the evidence estimator is unbiased in ``Z``: the
mean of ``exp(log Z-hat - log Z)`` over four seeds lies in (0.5, 1.8).
"""

import math

import numpy as np
import pytest
import torch
from scipy.stats import norm as snorm

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import smc2
from genjax_tpu_torch.parallel.resampling import _indices_from_counts, _systematic_counts
from torch_threads import _one_thread  # noqa: F401

Q, R = 1.0, 0.5  # transition and observation noise SDs
A_TRUE = 0.8
PRIOR_MEAN, PRIOR_SD = 0.5, 0.3
T = 20


def kalman_loglik(ys, a):
    """log p(y_1:T | a) for z_t ~ N(a z_t-1, Q²), y_t ~ N(z_t, R²), z_0 = 0."""
    mean, var, ll = 0.0, 0.0, 0.0
    for y in ys:
        mean, var = a * mean, a * a * var + Q**2
        s = var + R**2
        ll += snorm.logpdf(y, mean, np.sqrt(s))
        gain = var / s
        mean, var = mean + gain * (y - mean), (1 - gain) * var
    return ll


def make_data(seed=0):
    rng = np.random.RandomState(seed)
    z, ys = 0.0, []
    for _ in range(T):
        z = A_TRUE * z + Q * rng.randn()
        ys.append(z + R * rng.randn())
    return np.asarray(ys, np.float32)


def grid_posterior(ys):
    grid = np.linspace(-0.6, 1.8, 1201)
    lw = np.array([snorm.logpdf(a, PRIOR_MEAN, PRIOR_SD) + kalman_loglik(ys, a) for a in grid])
    log_ev = np.log(np.trapezoid(np.exp(lw - lw.max()), grid)) + lw.max()
    w = np.exp(lw - lw.max())
    w /= w.sum()
    mean = float(w @ grid)
    return mean, float(w @ (grid - mean) ** 2), float(log_ev)


YS = make_data()
MEAN_EXACT, VAR_EXACT, LOGEV_EXACT = grid_posterior(YS)


@g.gen
def kernel(c, x):
    a, z = c
    z_new = g.normal(a * z, Q) @ "z"
    y = g.normal(z_new, R) @ "y"
    return ((a, z_new), y)


def theta_sample(gen):
    return PRIOR_MEAN + PRIOR_SD * torch.randn((), generator=gen, device=gen.device)


def theta_logprior(a):
    return -0.5 * ((a - PRIOR_MEAN) / PRIOR_SD) ** 2 - math.log(PRIOR_SD) - 0.5 * math.log(2.0 * math.pi)


def _run(seed, **kw):
    return smc2(seed, kernel, theta_sample, theta_logprior, 0.0, torch.zeros(T), g.C[:, "y"].set(torch.from_numpy(YS)),
                n_theta=192, n_x=96, rw_scales=0.15, n_rejuv=2, device="cpu", **kw)


def test_theta_posterior_and_evidence():
    res = _run(0)
    w = torch.exp(res.log_weights).double()
    thetas = res.thetas.double()
    mean = float(w @ thetas)
    var = float(w @ (thetas - mean) ** 2)
    assert mean == pytest.approx(MEAN_EXACT, abs=0.06)
    assert math.sqrt(var) == pytest.approx(math.sqrt(VAR_EXACT), rel=0.35)
    assert float(res.log_evidence) == pytest.approx(LOGEV_EXACT, abs=0.6)
    assert tuple(res.thetas.shape) == (192,) and tuple(res.ess_history.shape) == (T,)
    assert float(torch.logsumexp(res.log_weights, 0)) == pytest.approx(0.0, abs=1e-5)


def test_rejuvenation_fires_and_accepts():
    res = _run(1)
    assert float(res.rejuv_accept_rate) > 0.05
    assert float(res.ess_history.min()) < 0.9 * 192


def test_evidence_unbiasedness_across_seeds():
    ratios = [math.exp(float(_run(10 + s).log_evidence) - LOGEV_EXACT) for s in range(4)]
    assert 0.5 < np.mean(ratios) < 1.8, ratios


def test_inner_resample_indices_equal_the_counts_expansion():
    """The inner filters' systematic indices (searchsorted on the vmapped
    counts' cumulative sums) are the counts expanded row by row."""
    gen = torch.Generator().manual_seed(3)
    ws = torch.randn(5, 17, generator=gen) * 2.0
    u = torch.rand(5, generator=gen)
    counts = torch.func.vmap(_systematic_counts, in_dims=(0, 0, None))(u, ws, 17)
    targets = torch.arange(17).expand(5, 17).contiguous()
    idx = torch.searchsorted(torch.cumsum(counts, dim=1), targets, right=True)
    for b in range(5):
        assert torch.equal(counts[b], _systematic_counts(u[b], ws[b], 17))
        assert torch.equal(idx[b], _indices_from_counts(counts[b], 17))


class _FiveRanks:
    """A mesh axis of five ranks, enough to reach ``smc2``'s sharding check
    without a process group."""

    def axis_size(self, axis):
        return 5


def test_mesh_and_defaults():
    with pytest.raises(ValueError, match="must divide over 5 shards"):
        _run(0, mesh=_FiveRanks())
    with pytest.raises(ValueError, match="n_steps"):
        smc2(0, kernel, theta_sample, theta_logprior, 0.0, None, g.C[:, "y"].set(torch.from_numpy(YS)),
             n_theta=4, n_x=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            smc2(0, kernel, theta_sample, theta_logprior, 0.0, torch.zeros(T),
                 g.C[:, "y"].set(torch.from_numpy(YS)), n_theta=4, n_x=4)
