"""The port's distributions against ``genjax_tpu`` and scipy.

Log-densities are held against the JAX catalog on the same numpy grids
(rtol 1e-6, and equal infinities and NaNs); sampling is held in law against
scipy with a Kolmogorov-Smirnov test (p > 1e-3 at fixed seeds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as ss
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g

RTOL = 1e-6
# beta's float32 normaliser sums lgamma terms that cancel (up to ~20 in
# magnitude on these grids), and the reference's XLA lgamma is itself off by
# up to 7e-7 (lgamma(4): 1.7917602 vs 1.7917595 in float64); so beta is held
# with atol 1e-6 beside RTOL, both to the reference and to scipy in float64
BETA_ATOL = 1e-6

_GRID = np.linspace(-3.0, 3.0, 13, dtype=np.float32)
_POS = np.asarray([-1.0, 0.0, 1e-3, 0.2, 0.7, 1.0, 2.5, 9.0], np.float32)
_UNIT = np.asarray([-0.5, 0.0, 0.01, 0.3, 0.5, 0.9, 1.0, 1.5], np.float32)

LOGPDF_CASES = {
    "normal": (_GRID, (0.3, 1.7)),
    "normal_array_params": (_GRID, (np.float32(-0.5), np.full(13, 0.4, np.float32))),
    "log_normal": (_POS, (0.0, 0.5)),
    "log_normal_shifted": (_POS, (0.4, 1.3)),
    "mv_normal_diag": (
        np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32),
        (np.zeros(6, np.float32), np.linspace(0.5, 2.0, 6, dtype=np.float32)),
    ),
    "beta": (_UNIT, (2.0, 3.0)),
    "beta_u_shaped": (_UNIT, (0.5, 0.7)),
    "flip": (np.asarray([0.0, 1.0, 1.0, 0.0], np.float32), (np.asarray([0.1, 0.5, 0.9, 1.0], np.float32),)),
}


def _dist_name(case: str) -> str:
    for name in ("mv_normal_diag", "log_normal", "normal", "beta", "flip"):
        if case.startswith(name):
            return name
    raise KeyError(case)


@pytest.mark.parametrize("case", sorted(LOGPDF_CASES))
def test_logpdf_matches_jax(case):
    v, params = LOGPDF_CASES[case]
    name = _dist_name(case)
    ref = np.asarray(getattr(gj, name).logpdf(jnp.asarray(v), *params))
    got = getattr(g, name).logpdf(v, *params).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=BETA_ATOL if name == "beta" else 0)


@pytest.mark.parametrize("params", [(2.0, 3.0), (0.5, 0.7), (9.0, 12.0)])
def test_beta_logpdf_matches_scipy(params):
    got = g.beta.logpdf(_UNIT, *params).numpy()
    ref = ss.beta(*params).logpdf(_UNIT.astype(np.float64))
    ref = np.where((_UNIT < 0) | (_UNIT > 1), -np.inf, ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=BETA_ATOL)


def test_log_normal_off_support_is_minus_inf():
    lp = g.log_normal.logpdf(np.asarray([-2.0, -1e-6, 0.0], np.float32), 0.0, 0.5)
    assert torch.equal(lp, torch.full((3,), -torch.inf))


def _draws(dist, params, n=20000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = [torch.full((n,), float(p)) for p in params]
    return dist.sample(gen, *params).numpy()


SAMPLE_CASES = {
    "normal": (g.normal, (0.3, 1.7), ss.norm(0.3, 1.7).cdf),
    "log_normal": (g.log_normal, (0.0, 0.5), ss.lognorm(0.5).cdf),
    "beta": (g.beta, (2.0, 3.0), ss.beta(2.0, 3.0).cdf),
    "beta_small": (g.beta, (0.5, 0.7), ss.beta(0.5, 0.7).cdf),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sampling_in_law(case):
    dist, params, cdf = SAMPLE_CASES[case]
    x = _draws(dist, params)
    assert ss.kstest(x, cdf).pvalue > 1e-3


def test_mv_normal_diag_sampling_in_law():
    gen = torch.Generator().manual_seed(1)
    scale = torch.linspace(0.5, 2.0, 4)
    x = g.mv_normal_diag.sample(gen, torch.zeros(20000, 4), scale).numpy()
    for j in range(4):
        assert ss.kstest(x[:, j], ss.norm(0.0, float(scale[j])).cdf).pvalue > 1e-3


def test_flip_sampling_in_law():
    gen = torch.Generator().manual_seed(2)
    x = g.flip.sample(gen, torch.full((20000,), 0.3)).numpy()
    assert x.dtype == np.bool_
    assert ss.binomtest(int(x.sum()), x.size, 0.3).pvalue > 1e-3


# ----------------------------------------------------------------------
# sample_shape: TFP semantics, sample_shape + batch_shape
# ----------------------------------------------------------------------

SHAPE_CASES = {
    "normal": (lambda m, z: (z(3), 1.0), (5, 3)),
    "log_normal": (lambda m, z: (z(3), 0.5), (5, 3)),
    "mv_normal_diag": (lambda m, z: (z(3), z(3) + 1.0), (5, 3)),
    "mv_normal": (lambda m, z: (z(3), m.eye(3)), (5, 3)),
    "beta": (lambda m, z: (z(3) + 2.0, 3.0), (5, 3)),
    "flip": (lambda m, z: (z(4) + 0.5,), (5, 4)),
}


@pytest.mark.parametrize("name", sorted(SHAPE_CASES))
def test_sample_shape_prepends_batch(name):
    import jax

    make, expected = SHAPE_CASES[name]
    t_draws = getattr(g, name).sample(
        torch.Generator().manual_seed(0), *make(torch, torch.zeros), sample_shape=(5,)
    )
    j_draws = getattr(gj, name).sample(jax.random.key(0), *make(jnp, jnp.zeros), sample_shape=(5,))
    assert tuple(t_draws.shape) == tuple(j_draws.shape) == expected
    # independent draws, not one draw repeated
    assert len({tuple(row.reshape(-1).tolist()) for row in t_draws}) > 1
    # the log-density takes the keyword and ignores it
    lp = getattr(g, name).logpdf(t_draws, *make(torch, torch.zeros), sample_shape=(5,))
    assert bool(torch.isfinite(lp).all())


def test_sample_shape_through_the_gfi():
    """``dist(args, sample_shape=...) @ addr`` reaches the sampler through
    the keyword adaptor, and the trace scores what it drew."""
    gen = torch.Generator().manual_seed(1)
    tr = g.normal(torch.zeros(3), 1.0, sample_shape=(5,)).simulate(gen)
    assert tuple(tr.get_retval().shape) == (5, 3)
    torch.testing.assert_close(tr.get_score(), g.normal.logpdf(tr.get_retval(), torch.zeros(3), 1.0))

    @g.gen
    def model():
        return g.normal(0.0, 1.0, sample_shape=(4,)) @ "xs"

    tr = model.simulate(gen, ())
    assert tuple(tr["xs"].shape) == (4,)
    score, _ = model.assess(tr.get_choices(), ())
    torch.testing.assert_close(score.sum(), tr.get_score().sum())
    with pytest.raises(TypeError, match="unexpected keyword"):
        g.normal.sample(gen, 0.0, 1.0, shape=(4,))


_COVS = np.stack([np.eye(2), np.ones((2, 2))]).astype(np.float32)


def test_mv_normal_not_positive_definite_is_nan_like_reference():
    """A covariance that is not positive definite gives NaN where the
    reference does, and raises nothing: the batched logpdf, its
    ``torch.func.vmap``, a sample, and ``simulate`` through it (score NaN).
    The other batch element keeps its value (-1.8379 = -log(2 pi))."""
    import jax

    zeros = np.zeros(2, np.float32)
    ref = np.asarray(jax.vmap(lambda c: gj.mv_normal.logpdf(zeros, zeros, c))(jnp.asarray(_COVS)))
    covs = torch.from_numpy(_COVS)
    batched = g.mv_normal.logpdf(torch.zeros(2), torch.zeros(2), covs).numpy()
    vmapped = torch.func.vmap(lambda c: g.mv_normal.logpdf(torch.zeros(2), torch.zeros(2), c))(covs).numpy()
    for got in (batched, vmapped):
        np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
        assert np.isnan(got[1]) and np.isnan(ref[1])
    assert abs(got[0] + 1.8379) < 1e-4
    sample = g.mv_normal.sample(torch.Generator().manual_seed(0), torch.zeros(2), covs)
    assert torch.isfinite(sample[0]).all() and torch.isnan(sample[1]).all()

    @g.gen
    def model():
        return g.mv_normal(torch.zeros(2), covs[1]) @ "x"

    tr = model.simulate(torch.Generator().manual_seed(0), ())
    assert torch.isnan(tr.get_score()) and torch.isnan(tr.get_retval()).all()


def test_gp_closed_forms_not_positive_definite_are_nan():
    """The GP closed forms on a Gram matrix that is not positive definite
    (a negative jitter: ``K - 2 I``) give NaN, as the reference's
    ``jnp.linalg.cholesky`` does, instead of raising."""
    from genjax_tpu.models import gp_log_marginal as ref_lml
    from genjax_tpu_torch.models import gp_log_marginal, gp_posterior

    X = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    y = np.sin(X).astype(np.float32)
    ref = float(ref_lml(X, y, 1.0, 0.3, 0.0, jitter=-2.0))
    got = gp_log_marginal(X, y, 1.0, 0.3, 0.0, jitter=-2.0, device="cpu")
    assert np.isnan(ref) and torch.isnan(got)
    mean, cov = gp_posterior(X, y, X[:2], 1.0, 0.3, 0.0, jitter=-2.0, device="cpu")
    assert torch.isnan(mean).all() and torch.isnan(cov).all()
