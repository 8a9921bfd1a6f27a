"""The port's GP models and ``mv_normal`` against ``genjax_tpu``.

- The closed forms (Gram matrix, log marginal, predictive, Laplace fit and
  its predictive) and ``mv_normal``'s log-density equal the reference's on
  the same numpy inputs to rtol 1e-5, with an absolute floor of 1e-5 times
  the largest reference entry for entries that cancel to near zero.
- ``gp_regression``'s ``assess`` score and ``generate`` weight on choices
  fixed from numpy equal the reference's to rtol 1e-4.
- The four closed forms that take ``device`` run on the card by default
  and raise without one, naming ``device="cpu"``.
- ``mv_normal`` sampling agrees in law with its covariance.
- The ESS audit of ``tests/models/test_gp_classify.py``: exact latent
  sampling through the port's ``ess_sweep_cols`` agrees with the Laplace
  mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as ss
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.models import gp as jgp
from genjax_tpu_torch.interop import choice_map_from_numpy
from genjax_tpu_torch.kernels import ess_sweep_cols
from genjax_tpu_torch.models import gp as tgp
from torch_threads import _one_thread  # noqa: F401


RTOL = 1e-5

RNG = np.random.RandomState(0)
X = RNG.randn(12, 2).astype(np.float32)
XT = RNG.randn(5, 2).astype(np.float32)
Y = RNG.randn(12).astype(np.float32)
AMP, LS, NOISE = 1.3, 0.9, 0.3

N_CLS = 14
X_CLS = np.sort(RNG.uniform(-2, 2, (N_CLS, 1)), axis=0).astype(np.float32)
Y_CLS = (RNG.rand(N_CLS) < 0.5).astype(np.float32)


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()))


# each closed form, called with the reference's arguments (the port's also
# take ``device``, given as ``**kw``)
CLOSED_FORMS = {
    "sq_exp_kernel": lambda m, **kw: [m.sq_exp_kernel(X, XT, AMP, LS)],
    "sq_exp_kernel_1d_points": lambda m, **kw: [m.sq_exp_kernel(X[:, 0], XT[:, 0], AMP, LS)],
    "gp_log_marginal": lambda m, **kw: [m.gp_log_marginal(X, Y, AMP, LS, NOISE, **kw)],
    "gp_log_marginal_jitter": lambda m, **kw: [m.gp_log_marginal(X, Y, 0.7, 1.4, 0.1, jitter=1e-3, **kw)],
    "gp_posterior": lambda m, **kw: list(m.gp_posterior(X, Y, XT, AMP, LS, NOISE, **kw)),
    "gp_classify_laplace": lambda m, **kw: list(m.gp_classify_laplace(X_CLS, Y_CLS, 1.5, 0.8, **kw)),
    "gp_classify_laplace_5_newton": lambda m, **kw: list(
        m.gp_classify_laplace(X_CLS, Y_CLS, 1.5, 0.8, n_newton=5, **kw)
    ),
    "gp_classify_predict": lambda m, **kw: list(m.gp_classify_predict(X_CLS, Y_CLS, XT[:, :1], 1.5, 0.8, **kw)),
}
ON_THE_CARD = ["gp_log_marginal", "gp_posterior", "gp_classify_laplace", "gp_classify_predict"]


@pytest.mark.parametrize("name", sorted(CLOSED_FORMS))
def test_closed_forms_match_reference(name):
    refs = CLOSED_FORMS[name](jgp)
    gots = CLOSED_FORMS[name](tgp, **({"device": "cpu"} if name.startswith("gp_") else {}))
    assert len(refs) == len(gots)
    for got, ref in zip(gots, refs):
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(np.shape(ref))
        _close(got, ref)


@pytest.mark.parametrize("name", ON_THE_CARD)
def test_closed_forms_default_to_the_card(name, monkeypatch):
    """Without a card the default ``device`` raises, naming ``device='cpu'``;
    ``device="cpu"`` runs on the CPU, numpy inputs included."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLOSED_FORMS[name](tgp)
    assert all(t.device.type == "cpu" for t in CLOSED_FORMS[name](tgp, device="cpu"))


def _mvn_inputs(seed, batch):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(5, 5))
    cov = (A @ A.T + 5 * np.eye(5)).astype(np.float32) / 5
    v = rng.normal(size=batch + (5,)).astype(np.float32)
    return v, rng.normal(size=5).astype(np.float32), cov


@pytest.mark.parametrize("seed, batch", [(0, ()), (1, (7,)), (2, (3, 4))])
def test_mv_normal_logpdf_matches_reference(seed, batch):
    v, loc, cov = _mvn_inputs(seed, batch)
    ref = np.asarray(gj.mv_normal.logpdf(jnp.asarray(v), loc, cov))
    got = g.mv_normal.logpdf(v, loc, cov)
    assert tuple(got.shape) == batch
    _close(got, ref)


def test_mv_normal_sampling_in_law():
    _, loc, cov = _mvn_inputs(3, ())
    gen = torch.Generator().manual_seed(4)
    x = g.mv_normal.sample(gen, torch.as_tensor(np.tile(loc, (20000, 1))), cov).numpy()
    assert x.shape == (20000, 5)
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.05)
    # each coordinate and a whitened projection are normal
    for j in range(5):
        assert ss.kstest(x[:, j], ss.norm(loc[j], np.sqrt(cov[j, j])).cdf).pvalue > 1e-3
    w = np.linalg.solve(np.linalg.cholesky(cov.astype(np.float64)), (x - loc).T)
    assert ss.kstest(w.sum(axis=0) / np.sqrt(5), ss.norm().cdf).pvalue > 1e-3
    # the batch shape of the location, and a trace whose score is the density
    tr = g.mv_normal.simulate(gen, (torch.zeros(5), torch.as_tensor(cov)))
    torch.testing.assert_close(tr.get_score(), g.mv_normal.logpdf(tr.get_retval(), 0.0, cov))


def _hyper_choices(k):
    rng = np.random.default_rng(10 + k)
    la, ll, ln = (np.float32(v) for v in rng.normal(scale=0.5, size=3))
    return {("log_amp",): la, ("log_ls",): ll, ("log_noise",): ln, ("y",): Y}


@pytest.mark.parametrize("k", range(3))
def test_gp_regression_assess_and_generate_match_reference(k):
    flat = _hyper_choices(k)
    jm, tm = jgp.gp_regression(X), tgp.gp_regression(X)
    jchm = gj.ChoiceMap.d({a[0]: v for a, v in flat.items()})
    j_score, _ = jm.assess(jchm, ())
    t_score, t_ret = tm.assess(choice_map_from_numpy(flat), ())
    np.testing.assert_allclose(float(t_score), float(j_score), rtol=1e-4)
    np.testing.assert_array_equal(t_ret.numpy(), Y)
    _, j_w = jm.generate(jax.random.key(k), jchm, ())
    tr, t_w = tm.generate(torch.Generator().manual_seed(k), choice_map_from_numpy(flat), ())
    np.testing.assert_allclose(float(t_w), float(j_w), rtol=1e-4)
    np.testing.assert_allclose(float(tr.get_score()), float(j_w), rtol=1e-4)


def test_gp_regression_generate_weight_is_the_exact_marginal():
    """With ``y`` constrained, the weight is the GP log marginal at the
    sampled hyperparameters (the model marginalizes f exactly)."""
    tm = tgp.gp_regression(X, jitter=1e-5)
    tr, w = tm.generate(torch.Generator().manual_seed(1), g.C["y"].set(Y), ())
    ch = tr.get_choices()
    amp, ls, noise = (torch.exp(ch[a]) for a in ("log_amp", "log_ls", "log_noise"))
    torch.testing.assert_close(w, tgp.gp_log_marginal(X, Y, amp, ls, noise, jitter=1e-5, device="cpu"), rtol=1e-4, atol=0)


def test_ess_audit_agrees_with_laplace_mode():
    """``test_gp_classify.py::test_ess_audit_agrees_with_mode`` through the
    port: exact latent sampling by elliptical slice, posterior mean of f
    within 0.25 of the Laplace mode (the logistic posterior is log-concave
    and near-Gaussian at this N)."""
    rng = np.random.RandomState(0)
    n = 14
    Xc = np.sort(rng.uniform(-2, 2, (n, 1)), axis=0).astype(np.float32)
    K = tgp.sq_exp_kernel(Xc, Xc, 1.5, 0.8).double().numpy() + 1e-5 * np.eye(n)
    f_true = rng.multivariate_normal(np.zeros(n), K)
    y = torch.as_tensor((rng.rand(n) < 1.0 / (1.0 + np.exp(-f_true))).astype(np.float32))

    def ll(f_cols):
        return torch.sum(y[:, None] * f_cols - torch.logaddexp(torch.zeros_like(f_cols), f_cols), dim=0)

    f_cols, _ = ess_sweep_cols(ll, torch.zeros(n, 2048), 0, n_steps=300, chol_prior=np.linalg.cholesky(K))
    f_hat, _, _ = tgp.gp_classify_laplace(Xc, y.numpy(), 1.5, 0.8, device="cpu")
    np.testing.assert_allclose(f_cols.numpy().mean(axis=1), f_hat.numpy(), atol=0.25)
