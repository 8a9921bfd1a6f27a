"""The port's distribution catalog against ``genjax_tpu/dists/catalog.py``.

Every one of the reference's 48 distributions is a case of each test:

- the log-density on the same numpy grid (in and out of support) equals the
  reference's to rtol 1e-5 with atol 1e-5 (lgamma sums that cancel:
  ``beta_binomial``, ``dirichlet_multinomial`` and the beta quotient's
  quadrature differ by up to 6e-6 absolute), with equal infinities;
- the sampler is held in law at a fixed seed with 20,000 draws: a scalar
  continuous family by Kolmogorov-Smirnov against its float64 CDF (p >
  1e-3), a discrete one by the frequency of its first values against the
  float64 pmf, an event family by its mean and variance, each within 5
  standard errors;
- ``sample_shape`` prepends its axes, and the sampler runs under
  ``torch.func.vmap(..., randomness="different")``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as ss
import torch
from torch_threads import _one_thread  # noqa: F401

import genjax_tpu.dists.catalog as R
import genjax_tpu_torch as g
import genjax_tpu_torch.dists.catalog as P

N = 20000
f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
_rng = np.random.default_rng(0)
GRID = f32(np.linspace(-3, 3, 13))
POS = f32([-1.0, 0.0, 1e-3, 0.2, 0.7, 1.0, 2.5, 9.0])
UNIT = f32([-0.5, 0.0, 0.01, 0.3, 0.5, 0.9, 1.0, 1.5])
INT = f32([-1, 0, 1, 2, 3, 5, 8, 12])
SIMPLEX = f32([[0.2, 0.3, 0.5], [0.1, 0.1, 0.8], [0.0, 0.5, 0.5], [0.3, 0.3, 0.3]])
COUNTS = f32([[1, 2, 2], [0, 0, 5], [5, 0, 0], [2, 2, 1]])
LOGIT04 = float(np.log(0.4 / 0.6))
LOGIT03 = float(np.log(0.3 / 0.7))
LOGP = f32(np.log([0.2, 0.3, 0.5]))
ALPHA = f32([2.0, 3.0, 4.0])


def _unit(n, d):
    x = _rng.normal(size=(n, d))
    return f32(x / np.linalg.norm(x, axis=-1, keepdims=True))


# name -> (values, parameters) for the log-density comparison
CASES = {
    "normal": (GRID, (0.3, 1.7)),
    "cauchy": (GRID, (0.5, 2.0)),
    "laplace": (GRID, (0.5, 2.0)),
    "logistic": (GRID, (0.5, 2.0)),
    "gumbel": (GRID, (0.5, 2.0)),
    "student_t": (GRID, (4.0, 0.5, 2.0)),
    "half_normal": (POS, (1.5,)),
    "half_cauchy": (POS, (0.0, 1.5)),
    "half_student_t": (POS, (4.0, 0.0, 1.5)),
    "uniform": (UNIT, (0.0, 1.0)),
    "exponential": (POS, (2.0,)),
    "gamma": (POS, (2.0, 3.0)),
    "inverse_gamma": (POS, (2.0, 3.0)),
    "chi": (POS, (3.0,)),
    "chi2": (POS, (3.0,)),
    "weibull": (POS, (2.0, 1.5)),
    "log_normal": (POS, (0.3, 0.8)),
    "logit_normal": (UNIT[2:6], (0.3, 0.8)),
    "truncated_normal": (GRID, (0.0, 1.0, -1.0, 2.0)),
    "truncated_cauchy": (GRID, (0.0, 1.0, -2.0, 3.0)),
    "kumaraswamy": (UNIT, (2.0, 3.0)),
    "moyal": (GRID, (0.5, 2.0)),
    "double_sided_maxwell": (GRID, (0.5, 1.0)),
    "exp_gamma": (GRID, (2.0, 1.5)),
    "exp_inverse_gamma": (GRID, (2.0, 1.5)),
    "inverse_gaussian": (POS, (2.0, 3.0)),
    "von_mises": (GRID, (0.5, 2.0)),
    "lambert_w_normal": (GRID, (0.3, 1.0, 0.1)),
    "beta": (UNIT, (2.0, 3.0)),
    "bernoulli": (f32([0, 1, 1, 0]), (f32([-1.0, 0.0, 2.0, 0.5]),)),
    "flip": (f32([0, 1, 1, 0]), (f32([0.1, 0.5, 0.9, 1.0]),)),
    "categorical": (np.asarray([0, 1, 2, 3, -1]), (LOGP,)),
    "binomial": (INT, (10.0, LOGIT04)),
    "geometric": (INT, (LOGIT03,)),
    "poisson": (f32([-1, 0, 1, 2, 3.5, 5, 8, 12]), (3.5,)),
    "negative_binomial": (INT, (5.0, LOGIT04)),
    "beta_binomial": (INT, (10.0, 2.0, 3.0)),
    "skellam": (INT, (3.0, 2.0)),
    "zipf": (INT, (2.5,)),
    "non_central_chi2": (POS, (3.0, 1.5)),
    "dirichlet": (SIMPLEX, (ALPHA,)),
    "multinomial": (COUNTS, (5.0, LOGP)),
    "dirichlet_multinomial": (COUNTS, (5.0, ALPHA)),
    "mv_normal_diag": (f32(_rng.normal(size=(4, 3))), (f32([0.5, -0.5, 0.0]), f32([1.5, 0.5, 1.0]))),
    "mv_normal": (f32(_rng.normal(size=(4, 2))), (f32([0.5, -0.5]), f32([[2.0, 0.3], [0.3, 1.0]]))),
    "power_spherical": (_unit(4, 3), (f32([0.0, 0.0, 1.0]), 5.0)),
    "von_mises_fisher": (_unit(4, 3), (f32([0.0, 0.0, 1.0]), 5.0)),
    "beta_quotient": (POS, (3.0, 2.0, 4.0, 2.0)),
}
NAMES = sorted(CASES)


def test_catalog_has_the_reference_48():
    assert sorted(P.__all__) == sorted(R.__all__) == NAMES
    assert len(NAMES) == 48
    assert all(hasattr(g, name) for name in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_logpdf_matches_reference(name):
    v, args = CASES[name]
    if name == "dirichlet":  # the reference reduces over axis 0: one value a call
        ref = np.stack([np.asarray(R.dirichlet.logpdf(jnp.asarray(x), *args)) for x in v])
    else:
        ref = np.asarray(getattr(R, name).logpdf(jnp.asarray(v), *args))
    got = getattr(P, name).logpdf(torch.as_tensor(v), *args).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# in law
# ---------------------------------------------------------------------


def _cauchy_cdf(x):
    return ss.cauchy.cdf(x)


def _lw_cdf(x, loc=0.3, scale=1.0, delta=0.1):
    z = (x - loc) / scale
    u = np.sign(z) * np.sqrt(np.real(sps.lambertw(delta * z * z)) / delta)
    return ss.norm.cdf(u)


# scalar continuous families: parameters and a float64 CDF
KS = {
    "normal": ((0.3, 1.7), ss.norm(0.3, 1.7).cdf),
    "cauchy": ((0.5, 2.0), ss.cauchy(0.5, 2.0).cdf),
    "laplace": ((0.5, 2.0), ss.laplace(0.5, 2.0).cdf),
    "logistic": ((0.5, 2.0), ss.logistic(0.5, 2.0).cdf),
    "gumbel": ((0.5, 2.0), ss.gumbel_r(0.5, 2.0).cdf),
    "student_t": ((4.0, 0.5, 2.0), ss.t(4.0, 0.5, 2.0).cdf),
    "half_normal": ((1.5,), ss.halfnorm(0, 1.5).cdf),
    "half_cauchy": ((0.0, 1.5), ss.halfcauchy(0, 1.5).cdf),
    "half_student_t": ((4.0, 0.0, 1.5), lambda x: 2 * ss.t(4.0, 0.0, 1.5).cdf(x) - 1),
    "uniform": ((1.0, 3.0), ss.uniform(1.0, 2.0).cdf),
    "exponential": ((2.0,), ss.expon(scale=0.5).cdf),
    "gamma": ((2.0, 3.0), ss.gamma(2.0, scale=1 / 3).cdf),
    "inverse_gamma": ((2.0, 3.0), ss.invgamma(2.0, scale=3.0).cdf),
    "chi": ((3.0,), ss.chi(3.0).cdf),
    "chi2": ((3.0,), ss.chi2(3.0).cdf),
    "weibull": ((2.0, 1.5), ss.weibull_min(2.0, scale=1.5).cdf),
    "log_normal": ((0.3, 0.8), ss.lognorm(0.8, scale=np.exp(0.3)).cdf),
    "logit_normal": ((0.3, 0.8), lambda x: ss.norm(0.3, 0.8).cdf(np.log(x) - np.log1p(-x))),
    "truncated_normal": ((0.0, 1.0, -1.0, 2.0), ss.truncnorm(-1.0, 2.0).cdf),
    "truncated_cauchy": (
        (0.0, 1.0, -2.0, 3.0),
        lambda x: (_cauchy_cdf(x) - _cauchy_cdf(-2.0)) / (_cauchy_cdf(3.0) - _cauchy_cdf(-2.0)),
    ),
    "kumaraswamy": ((2.0, 3.0), lambda x: 1 - (1 - x**2.0) ** 3.0),
    "moyal": ((0.5, 2.0), ss.moyal(0.5, 2.0).cdf),
    "double_sided_maxwell": ((0.5, 1.0), lambda x: 0.5 + 0.5 * np.sign(x - 0.5) * ss.maxwell.cdf(np.abs(x - 0.5))),
    "exp_gamma": ((2.0, 1.5), lambda x: ss.gamma(2.0).cdf(1.5 * np.exp(x))),
    "exp_inverse_gamma": ((2.0, 1.5), lambda x: ss.gamma(2.0).sf(1.5 * np.exp(-x))),
    "inverse_gaussian": ((2.0, 3.0), ss.invgauss(2.0 / 3.0, scale=3.0).cdf),
    "lambert_w_normal": ((0.3, 1.0, 0.1), _lw_cdf),
    "beta": ((2.0, 3.0), ss.beta(2.0, 3.0).cdf),
    "non_central_chi2": ((3.0, 1.5), ss.ncx2(3.0, 1.5).cdf),
}

# discrete families: parameters and a float64 pmf over their first values
PMF = {
    "bernoulli": ((LOGIT03,), lambda k: ss.bernoulli(0.3).pmf(k), [0, 1]),
    "flip": ((0.3,), lambda k: ss.bernoulli(0.3).pmf(k), [0, 1]),
    "categorical": ((LOGP,), lambda k: np.asarray([0.2, 0.3, 0.5])[k], [0, 1, 2]),
    "binomial": ((10.0, LOGIT04), ss.binom(10, 0.4).pmf, [2, 3, 4, 5, 6]),
    "geometric": ((LOGIT03,), lambda k: ss.geom(0.3).pmf(np.asarray(k) + 1), [0, 1, 2, 3]),
    "poisson": ((3.5,), ss.poisson(3.5).pmf, [1, 2, 3, 4, 5]),
    "negative_binomial": ((5.0, LOGIT04), ss.nbinom(5, 0.6).pmf, [1, 2, 3, 4]),
    "beta_binomial": ((10.0, 2.0, 3.0), ss.betabinom(10, 2.0, 3.0).pmf, [1, 3, 5, 7]),
    "skellam": ((3.0, 2.0), ss.skellam(3.0, 2.0).pmf, [-1, 0, 1, 2, 3]),
    "zipf": ((2.5,), ss.zipf(2.5).pmf, [1, 2, 3]),
}


def _dm_moments(n, alpha):
    a0 = alpha.sum()
    p = alpha / a0
    return n * p, n * p * (1 - p) * (n + a0) / (1 + a0)


def _ps_t_moments(d, kappa):
    a, b = (d - 1) / 2 + kappa, (d - 1) / 2
    m = a / (a + b)
    return 2 * m - 1, 4 * a * b / ((a + b) ** 2 * (a + b + 1))


_PS_M, _PS_V = _ps_t_moments(3, 5.0)
_VMF_M = 1 / math.tanh(5.0) - 1 / 5.0
_p = np.asarray([0.2, 0.3, 0.5])

# event families (and the quotient): parameters, mean and variance
MOMENTS = {
    "dirichlet": ((ALPHA,), ss.dirichlet(ALPHA.astype(float)).mean(), ss.dirichlet(ALPHA.astype(float)).var()),
    "multinomial": ((5.0, LOGP), 5 * _p, 5 * _p * (1 - _p)),
    "dirichlet_multinomial": ((5.0, ALPHA), *_dm_moments(5.0, ALPHA.astype(float))),
    "mv_normal_diag": ((f32([0.5, -0.5, 0.0]), f32([1.5, 0.5, 1.0])), [0.5, -0.5, 0.0], [2.25, 0.25, 1.0]),
    "mv_normal": ((f32([0.5, -0.5]), f32([[2.0, 0.3], [0.3, 1.0]])), [0.5, -0.5], [2.0, 1.0]),
    "power_spherical": ((f32([0.0, 0.0, 1.0]), 5.0), [0.0, 0.0, _PS_M], [None, None, _PS_V]),
    "von_mises_fisher": ((f32([0.0, 0.0, 1.0]), 5.0), [0.0, 0.0, _VMF_M], None),
    "beta_quotient": ((3.0, 2.0, 4.0, 2.0), 1.0, 1.0 / 3.0),
}

LAW_NAMES = sorted(set(KS) | set(PMF) | set(MOMENTS) | {"von_mises"})


def test_every_distribution_has_a_law_case():
    assert LAW_NAMES == NAMES


def _draws(name, args, seed):
    gen = torch.Generator().manual_seed(seed)
    return getattr(g, name).sample(gen, *args, sample_shape=(N,))


@pytest.mark.parametrize("name", LAW_NAMES)
def test_sampler_in_law(name):
    seed = NAMES.index(name)
    if name == "von_mises":
        x = _draws(name, (0.5, 2.0), seed).double().numpy()
        d = np.remainder(x - 0.5 + math.pi, 2 * math.pi) - math.pi
        assert ss.kstest(d, ss.vonmises(2.0).cdf).pvalue > 1e-3
    elif name in KS:
        args, cdf = KS[name]
        x = _draws(name, args, seed)
        assert x.shape == (N,) and x.dtype == torch.float32
        assert ss.kstest(x.double().numpy(), cdf).pvalue > 1e-3
    elif name in PMF:
        args, pmf, values = PMF[name]
        x = _draws(name, args, seed).numpy()
        assert x.shape == (N,)
        for k in values:
            p = float(pmf(k))
            assert abs(np.mean(x == k) - p) < 5 * math.sqrt(p * (1 - p) / N), (k, np.mean(x == k), p)
    else:
        args, mean, var = MOMENTS[name]
        x = _draws(name, args, seed).double().numpy()
        m, s = x.mean(0), x.std(0)
        np.testing.assert_array_less(np.abs(m - np.asarray(mean, float)), 5 * s / math.sqrt(N) + 1e-12)
        if var is not None:
            for i, want in np.ndenumerate(np.asarray(var, object)):
                if want is None:
                    continue
                xi = x[(slice(None),) + i]
                se = math.sqrt(np.mean((xi - xi.mean()) ** 4) / N)
                assert abs(xi.var() - want) < 5 * se, (i, xi.var(), want)


@pytest.mark.parametrize("name", NAMES)
def test_sample_shape_and_vmap(name):
    _v, args = CASES[name]
    d = getattr(g, name)
    gen = torch.Generator().manual_seed(1)
    one = d.sample(gen, *args)
    many = d.sample(gen, *args, sample_shape=(3,))
    assert tuple(many.shape) == (3,) + tuple(one.shape)
    lanes = torch.func.vmap(lambda _: d.sample(gen, *args), randomness="different")(torch.zeros(5))
    assert tuple(lanes.shape) == (5,) + tuple(one.shape)
    assert lanes.dtype == one.dtype
    lp = d.logpdf(lanes[0], *args)
    assert bool(torch.all(torch.isfinite(lp)))


@pytest.mark.parametrize(
    "name,args,ref",
    [
        ("gamma", (1.7, 2.0, 3.0), ss.gamma.logpdf(1.7, 2.0, scale=1 / 3.0)),
        ("inverse_gamma", (0.7, 2.0, 3.0), ss.invgamma.logpdf(0.7, 2.0, scale=3.0)),
        ("student_t", (0.7, 4.0, 0.5, 2.0), ss.t.logpdf(0.7, 4.0, 0.5, 2.0)),
        ("weibull", (1.3, 2.0, 1.5), ss.weibull_min.logpdf(1.3, 2.0, scale=1.5)),
        ("truncated_normal", (0.5, 0.0, 1.0, -1.0, 2.0), ss.truncnorm.logpdf(0.5, -1.0, 2.0)),
        ("negative_binomial", (4, 5.0, LOGIT04), ss.nbinom.logpmf(4, 5, 0.6)),
        ("skellam", (2, 3.0, 2.0), ss.skellam.logpmf(2, 3.0, 2.0)),
        ("zipf", (3, 2.5), ss.zipf.logpmf(3, 2.5)),
        ("non_central_chi2", (2.5, 3.0, 1.5), ss.ncx2.logpdf(2.5, 3.0, 1.5)),
        ("inverse_gaussian", (1.0, 2.0, 3.0), ss.invgauss.logpdf(1.0, 2.0 / 3.0, scale=3.0)),
    ],
)
def test_parameterisation_against_scipy(name, args, ref):
    """The TFP parameter orders, as the reference's catalog test holds
    them (rel 1e-4)."""
    v, *params = args
    assert float(getattr(g, name).logpdf(torch.tensor(float(v)), *params)) == pytest.approx(ref, rel=1e-4)


def test_torch_distribution_draws_from_the_generator():
    d = g.torch_distribution(torch.distributions.Normal, "normal_td")
    loc, scale = torch.tensor(0.5), torch.tensor(2.0)
    a = d.sample(torch.Generator().manual_seed(3), loc, scale, sample_shape=(N,))
    torch.manual_seed(123)
    state = torch.random.get_rng_state()
    b = d.sample(torch.Generator().manual_seed(3), loc, scale, sample_shape=(N,))
    # a function of the generator alone, and the global stream untouched
    assert torch.equal(a, b)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert ss.kstest(a.double().numpy(), ss.norm(0.5, 2.0).cdf).pvalue > 1e-3
    v = torch.tensor([0.0, 1.0])
    expected = float(np.sum(ss.norm(0.5, 2.0).logpdf([0.0, 1.0])))
    assert float(d.logpdf(v, loc, scale)) == pytest.approx(expected, rel=1e-6)
    tr = d.simulate(torch.Generator().manual_seed(0), (loc, scale))
    assert float(tr.get_score()) == pytest.approx(float(d.logpdf(tr.get_retval(), loc, scale)))
