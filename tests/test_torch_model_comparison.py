"""WAIC, PSIS-LOO and ``compare`` (``inference/model_comparison.py``)
against ``genjax_tpu`` and the closed forms its tests use.

Deterministic to 1e-5 (relative) against the reference on the same
inputs: ``waic`` and ``psis_loo`` (elpd, se, p_eff, pointwise and
``pareto_k``), ``_gpd_fit`` and ``_psis_smooth_column`` with ties among the
ratios, and ``compare``'s rows. In law, at the reference test's tolerances
(``tests/inference/test_model_comparison.py``): the GPD fit recovers the
shape of generalised Pareto samples (0.08) and the scale (15%), PSIS-LOO
matches the exact leave-one-out predictive of a conjugate Gaussian model
(0.05 pointwise, 0.3 summed, every k-hat < 0.7), WAIC agrees with it
(0.2), and ``compare`` ranks the well-specified model first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import genpareto, norm

from genjax_tpu.inference import model_comparison as ref
from genjax_tpu_torch.inference import model_comparison as mc
from torch_threads import _one_thread  # noqa: F401

RTOL = 1e-5
# the reference jitted, as its own tests run it (eager, its column vmap
# dispatches op by op)
REF = {"waic": jax.jit(ref.waic), "psis_loo": jax.jit(ref.psis_loo)}


def _close(port, reference, rtol=RTOL):
    reference = np.asarray(reference, np.float64)
    port = port.detach().cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(port, reference, rtol=rtol, atol=rtol * max(1.0, np.abs(reference).max()))


def _loglik(s, n, seed, ties=False):
    ll = (np.random.default_rng(seed).normal(size=(s, n)) * 0.6 - 1.0).astype(np.float32)
    if ties:
        ll[:, ::2] = np.round(ll[:, ::2], 1)
    return ll


@pytest.mark.parametrize("s,n,seed,ties", [(200, 7, 0, False), (200, 7, 1, True), (400, 5, 2, False)])
@pytest.mark.parametrize("fn", ["waic", "psis_loo"])
def test_elpd_matches_reference(fn, s, n, seed, ties):
    ll = _loglik(s, n, seed, ties)
    got = getattr(mc, fn)(torch.from_numpy(ll))
    want = REF[fn](jnp.asarray(ll))
    for field in ("elpd", "se", "p_eff", "pointwise", "pareto_k"):
        if getattr(want, field) is None:
            assert getattr(got, field) is None
            continue
        _close(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("dist,ties", [("exponential", False), ("pareto", False), ("exponential", True)])
def test_gpd_fit_matches_reference(dist, ties):
    rng = np.random.default_rng(3)
    x = rng.exponential(size=60) if dist == "exponential" else rng.pareto(3.0, size=60)
    if ties:
        x = np.round(x, 1) + 0.05
    x = np.sort(x).astype(np.float32)
    k, sigma = mc._gpd_fit(torch.from_numpy(x))
    rk, rsigma = ref._gpd_fit(jnp.asarray(x))
    _close(k, rk)
    _close(sigma, rsigma)


@pytest.mark.parametrize("s,ties", [(100, False), (100, True)])
def test_psis_smooth_column_matches_reference(s, ties):
    lw = np.random.default_rng(4).normal(size=s).astype(np.float32)
    if ties:
        lw = np.round(lw, 1)
    lw = lw - lw.max()
    out, k = mc._psis_smooth_column(torch.from_numpy(lw), s)
    rout, rk = jax.jit(ref._psis_smooth_column, static_argnums=1)(jnp.asarray(lw), s)
    _close(out, rout)
    _close(k, rk)


def test_batched_smoothing_equals_column_by_column():
    lw = torch.from_numpy(_loglik(300, 6, 5, ties=True))
    out, ks = mc._psis_smooth(lw)
    for j in range(6):
        col, k = mc._psis_smooth_column(lw[:, j], 300)
        torch.testing.assert_close(out[:, j], col, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(ks[j], k, rtol=1e-6, atol=1e-6)


def test_compare_rows_match_reference():
    lls = {name: _loglik(200, 7, seed) for name, seed in (("a", 6), ("b", 7), ("c", 8))}
    got = mc.compare({k: mc.psis_loo(torch.from_numpy(v)) for k, v in lls.items()})
    want = ref.compare({k: REF["psis_loo"](jnp.asarray(v)) for k, v in lls.items()})
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got]), np.array([r[1:] for r in want]), rtol=1e-4, atol=1e-4)


# ---- in law, against closed forms (the reference test's tolerances)


@pytest.mark.parametrize("k_true", [0.1, 0.3, 0.6])
def test_gpd_fit_recovers_shape(k_true):
    x = np.sort(genpareto.rvs(k_true, scale=1.0, size=2000, random_state=1)).astype(np.float32)
    k, sigma = mc._gpd_fit(torch.from_numpy(x))
    assert float(k) == pytest.approx(k_true, abs=0.08)
    assert float(sigma) == pytest.approx(1.0, rel=0.15)


def _conjugate_loglik(ys, sigma, n_draws=4000, seed=2):
    n = len(ys)
    v = 1.0 / (1.0 + n / sigma**2)
    m = v * ys.sum() / sigma**2
    mus = m + np.sqrt(v) * np.random.RandomState(seed).randn(n_draws)
    return norm.logpdf(ys[None, :], mus[:, None], sigma).astype(np.float32)


def _exact_loo(ys, sigma):
    n, out = len(ys), []
    for i in range(n):
        rest = np.delete(ys, i)
        v = 1.0 / (1.0 + (n - 1) / sigma**2)
        out.append(norm.logpdf(ys[i], v * rest.sum() / sigma**2, np.sqrt(v + sigma**2)))
    return np.asarray(out)


YS = (np.random.RandomState(0).randn(12) * 0.8 + 0.5).astype(np.float32)


def test_psis_loo_matches_exact_loo():
    res = mc.psis_loo(torch.from_numpy(_conjugate_loglik(YS, 0.8)))
    exact = _exact_loo(YS, 0.8)
    np.testing.assert_allclose(res.pointwise.numpy(), exact, atol=0.05)
    assert float(res.elpd) == pytest.approx(exact.sum(), abs=0.3)
    assert float(res.pareto_k.max()) < 0.7


def test_waic_agrees_with_loo_when_well_specified():
    ll = torch.from_numpy(_conjugate_loglik(YS, 0.8))
    assert float(mc.waic(ll).elpd) == pytest.approx(float(mc.psis_loo(ll).elpd), abs=0.2)


def test_too_few_draws_fail_loudly():
    with pytest.raises(ValueError, match="at least 25"):
        mc.psis_loo(torch.zeros(10, 4))


def test_compare_ranks_true_model_first():
    rows = mc.compare({
        "good": mc.psis_loo(torch.from_numpy(_conjugate_loglik(YS, 0.8))),
        "bad": mc.psis_loo(torch.from_numpy(_conjugate_loglik(YS, 0.2))),
    })
    assert rows[0][0] == "good" and rows[0][2] == 0.0
    assert rows[1][2] < 0.0


def test_runs_where_the_loglik_lives():
    ll = torch.from_numpy(_loglik(100, 4, 9)).to(torch.float64)
    res = mc.psis_loo(ll)
    assert res.elpd.dtype == torch.float64 and res.pareto_k.device == ll.device
