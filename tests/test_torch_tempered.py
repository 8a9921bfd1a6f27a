"""Tempered SMC (``inference/tempered.py``) and the MALA and Rejuvenate
moves against ``genjax_tpu``, numpy and the closed forms.

Deterministic parts: ``_cess`` and ``_choose_delta`` against a float64
numpy transcription of the reference's ``cess``/``choose_delta``
(``genjax_tpu/inference/tempered.py:209-234``) to rel 1e-4 (float32 sums
over 4,096 particles); ``geometric_ladder`` exactly; ``_constrained_score``
of traces built from the same choices to 1e-5; MALA's weight against its
closed form recomputed from the two traces to 1e-5. In law, the
counterparts of ``tests/inference/test_tempered.py`` and
``test_adaptive_tempered.py`` with their particle counts and tolerances;
rejuvenation by MALA and Rejuvenate; NUTS refused.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference import tempered as ref_tempered
from genjax_tpu_torch.inference import tempered as tp
from genjax_tpu_torch.inference.requests import MALA, Rejuvenate
from genjax_tpu_torch.inference.tempered import adaptive_tempered_smc, geometric_ladder, tempered_smc
from torch_threads import _one_thread  # noqa: F401


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


def exact_logz(y):
    return -0.5 * math.log(2 * math.pi * 1.25) - y * y / 2.5  # y ~ N(0, 1 + 0.25)


def _weighted_mean(res, addr):
    w = torch.softmax(res.log_weights, 0)
    return float((w * res.traces.get_choices()[addr]).sum())


# ----- deterministic parts -----

def _np_cess(log_w, llhs, delta):
    log_w, llhs = log_w.astype(np.float64), llhs.astype(np.float64)
    k = log_w.shape[0]

    def lse(x):
        m = x.max()
        return m + np.log(np.exp(x - m).sum())

    logW = log_w - lse(log_w)
    lu = delta * llhs
    return k * np.exp(2.0 * lse(logW + lu) - lse(logW + 2.0 * lu))


def _np_choose_delta(log_w, llhs, beta, cess_target, n_bisect):
    k = log_w.shape[0]
    hi0, target = 1.0 - beta, cess_target * k
    lo, hi = 0.0, hi0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        if _np_cess(log_w, llhs, mid) < target:
            hi = mid
        else:
            lo = mid
    return hi0 if _np_cess(log_w, llhs, hi0) >= target else lo


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cess_and_choose_delta_match_numpy(seed):
    rng = np.random.default_rng(seed)
    log_w = rng.normal(size=4096).astype(np.float32) * 0.5
    llhs = (rng.normal(size=4096) * 20 - 30).astype(np.float32)
    for delta in (0.0, 1e-3, 0.02, 0.3):
        got = float(tp._cess(torch.from_numpy(log_w), torch.from_numpy(llhs), delta))
        assert got == pytest.approx(_np_cess(log_w, llhs, delta), rel=1e-4)
    for beta, target in ((0.0, 0.9), (0.4, 0.5), (0.999, 0.9)):
        got = float(tp._choose_delta(torch.from_numpy(log_w), torch.from_numpy(llhs), torch.tensor(beta), target, 30))
        want = _np_choose_delta(log_w, llhs, np.float32(beta), target, 30)
        assert got == pytest.approx(want, rel=1e-4, abs=1e-7), (beta, target)


def test_geometric_ladder_exact():
    for n, power in ((10, 3.0), (7, 2.0), (1, 3.0)):
        np.testing.assert_array_equal(geometric_ladder(n, power).numpy(),
                                      np.asarray(ref_tempered.geometric_ladder(n, power)))


def test_constrained_score_matches_reference():
    @gj.gen
    def ref_model():
        mu = gj.normal(0.0, 1.0) @ "mu"
        _ = gj.normal(mu, 0.5) @ "y"

    for mu, y in ((0.3, 1.5), (-1.2, 0.1)):
        tr, _ = conjugate.generate(torch.Generator().manual_seed(0), g.C["mu"].set(mu) | g.C["y"].set(y), ())
        rtr, _ = ref_model.generate(jax.random.key(0), gj.C["mu"].set(mu) | gj.C["y"].set(y), ())
        got = tp._constrained_score(g.C["y"].set(y), tr)
        want = ref_tempered._constrained_score(gj.C["y"].set(y), rtr)
        assert abs(float(got) - float(want)) <= 1e-5 * (1 + abs(float(want)))


def test_mala_weight_is_the_mh_ratio():
    """MALA's weight is ``log p(new) - log p(old) + log q(old | new) - log
    q(new | old)`` for the Langevin proposal ``N(x + eps^2/2 grad, eps^2)``,
    recomputed from the two traces."""
    eps = 0.4
    gen = torch.Generator().manual_seed(3)
    tr, _ = conjugate.generate(gen, g.C["y"].set(1.5), ())

    def log_p(mu):
        return -0.5 * mu * mu - 2.0 * (1.5 - mu) ** 2  # up to a constant

    def grad(mu):
        return -mu + 4.0 * (1.5 - mu)

    def log_q(to, frm):
        return -0.5 * ((to - frm - 0.5 * eps * eps * grad(frm)) / eps) ** 2

    for _ in range(5):
        new, w, _rd, _bwd = tr.edit(gen, MALA(g.S["mu"], eps))
        x, xn = float(tr["mu"]), float(new["mu"])
        want = log_p(xn) - log_p(x) + log_q(x, xn) - log_q(xn, x)
        assert float(w) == pytest.approx(want, abs=1e-5)
        tr = new


# ----- in law: tests/inference/test_tempered.py -----

def test_log_z_matches_exact():
    res = tempered_smc(0, conjugate, g.C["y"].set(1.5), (), n_particles=4096, betas=geometric_ladder(10),
                       rejuvenation=g.S["mu"], n_rejuvenation=2, device="cpu")
    assert float(res.log_marginal) == pytest.approx(exact_logz(1.5), abs=0.05)
    assert tuple(res.ess_history.shape) == tuple(res.accept_history.shape) == (10,)


def test_posterior_samples_hmc():
    res = tempered_smc(0, conjugate, g.C["y"].set(1.5), (), n_particles=4096, betas=geometric_ladder(12),
                       rejuvenation=g.HMC(g.S["mu"], 0.3, L=5), n_rejuvenation=2, device="cpu")
    assert _weighted_mean(res, "mu") == pytest.approx(1.2, abs=0.1)  # precision 5, mean 4 * 1.5 / 5


def test_hierarchical_prior_regenerate_invariance():
    """The tempered MH alpha of a prior ``Regenerate`` includes the change of
    the latent child's prior density: ``E[z1 | y = 2] = 2/3``."""

    @g.gen
    def chain3():
        z1 = g.normal(0.0, 1.0) @ "z1"
        z2 = g.normal(z1, 1.0) @ "z2"
        _ = g.normal(z2, 1.0) @ "y"

    res = tempered_smc(0, chain3, g.C["y"].set(2.0), (), n_particles=4096, betas=geometric_ladder(10),
                       rejuvenation=g.S["z1"], n_rejuvenation=3, device="cpu")
    assert float(res.log_marginal) == pytest.approx(
        -0.5 * math.log(2 * math.pi * 3.0) - 4.0 / 6.0, abs=0.05)
    assert _weighted_mean(res, "z1") == pytest.approx(2.0 / 3.0, abs=0.1)


def test_multimodal_benefit():
    @g.gen
    def bimodal():
        x = g.normal(0.0, 3.0) @ "x"
        _ = g.normal(x * x, 0.5) @ "y"

    res = tempered_smc(0, bimodal, g.C["y"].set(4.0), (), n_particles=2048, betas=geometric_ladder(15),
                       rejuvenation=g.HMC(g.S["x"], 0.1, L=5), n_rejuvenation=3, device="cpu")
    xs = res.traces.get_choices()["x"]
    w = torch.softmax(res.log_weights, 0)
    assert 0.15 < float((w * (xs > 0)).sum()) < 0.85
    assert float((w * (xs.abs() - 2.0).abs()).sum()) < 0.3


@pytest.mark.parametrize("move", ["mala", "rejuvenate"])
def test_mala_and_rejuvenate_rejuvenation(move):
    """The other two moves tempered SMC composes with: the evidence and the
    posterior mean of the conjugate model at 4,096 particles."""

    @g.gen
    def walk(m):
        return g.normal(m, 0.5) @ "mu"

    request = (MALA(g.S["mu"], 0.3) if move == "mala"
               else Rejuvenate(walk, lambda chm: (chm["mu"],)))
    res = tempered_smc(1, conjugate, g.C["y"].set(1.5), (), n_particles=4096, betas=geometric_ladder(10),
                       rejuvenation=request, n_rejuvenation=2, device="cpu")
    assert float(res.log_marginal) == pytest.approx(exact_logz(1.5), abs=0.05)
    assert _weighted_mean(res, "mu") == pytest.approx(1.2, abs=0.1)
    assert 0.1 < float(res.accept_history.mean()) <= 1.0


def test_nuts_rejuvenation_refused_and_entry_defaults():
    for request in (g.NUTS(g.S["mu"], 0.1), g.NUTS(g.S["mu"], 0.1).map(lambda d: d)):
        with pytest.raises(ValueError, match="does not support NUTS"):
            tempered_smc(0, conjugate, g.C["y"].set(1.5), (), n_particles=8, betas=[1.0],
                         rejuvenation=request, device="cpu")
        with pytest.raises(ValueError, match="does not support NUTS"):
            adaptive_tempered_smc(0, conjugate, g.C["y"].set(1.5), (), n_particles=8,
                                  rejuvenation=request, device="cpu")
    with pytest.raises(ValueError, match="cess_target"):
        adaptive_tempered_smc(0, conjugate, g.C["y"].set(1.5), (), n_particles=8, cess_target=1.0, device="cpu")
    if not torch.cuda.is_available():
        for call in (lambda: tempered_smc(0, conjugate, g.C["y"].set(1.5), (), n_particles=8, betas=[1.0]),
                     lambda: adaptive_tempered_smc(0, conjugate, g.C["y"].set(1.5), (), n_particles=8)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


# ----- in law: tests/inference/test_adaptive_tempered.py -----

N_OBS, SIGMA = 12, 0.4
YS = (np.random.RandomState(0).randn(N_OBS) * SIGMA + 1.1).astype(np.float32)
OBS = g.C["y"].set(torch.from_numpy(YS))


@g.gen
def iid_model():
    mu = g.normal(0.0, 1.0) @ "mu"
    g.mv_normal_diag(mu * torch.ones(N_OBS), SIGMA * torch.ones(N_OBS)) @ "y"


def _exact_iid_logz():
    cov = SIGMA**2 * np.eye(N_OBS) + np.ones((N_OBS, N_OBS))
    _, logdet = np.linalg.slogdet(cov)
    return float(-0.5 * YS @ np.linalg.solve(cov, YS) - 0.5 * logdet - 0.5 * N_OBS * np.log(2 * np.pi))


def _adaptive(seed, model=iid_model, eps=0.15):
    return adaptive_tempered_smc(seed, model, OBS, (), n_particles=2048,
                                 rejuvenation=g.HMC(g.S["mu"], eps, L=5), device="cpu")


def test_adaptive_log_evidence_and_ladder():
    lzs, results = [], []
    for s in range(4):
        res = _adaptive(s)
        lzs.append(float(res.log_marginal))
        results.append(res)
    np.testing.assert_allclose(np.mean(lzs), _exact_iid_logz(), atol=0.05)
    res = results[0]
    betas = res.beta_history.numpy()
    n = int(res.n_rungs)
    assert 1 < n < 64 and betas.shape == (64,)
    active = betas[:n]
    assert np.all(np.diff(np.concatenate([[0.0], active])) > 0)
    np.testing.assert_allclose(active[-1], 1.0)
    assert np.all(betas[n:] == active[-1]) and float(res.final_beta) == 1.0
    assert np.all(res.ess_history.numpy()[n:] == 0.0) and np.all(res.accept_history.numpy()[n:] == 0.0)
    assert np.all(res.ess_history.numpy()[:n] > 0.0)
    # posterior moments (seed 3, as the reference's test)
    v = 1.0 / (1.0 + N_OBS / SIGMA**2)
    assert _weighted_mean(results[3], "mu") == pytest.approx(v * YS.sum() / SIGMA**2, abs=0.03)


def test_adaptive_matches_fixed_ladder_evidence():
    fixed = tempered_smc(7, iid_model, OBS, (), n_particles=2048, betas=geometric_ladder(24),
                         rejuvenation=g.HMC(g.S["mu"], 0.15, L=5), device="cpu")
    np.testing.assert_allclose(float(_adaptive(7).log_marginal), float(fixed.log_marginal), atol=0.1)


def test_sharper_likelihood_needs_more_rungs():
    @g.gen
    def sharp():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.mv_normal_diag(mu * torch.ones(N_OBS), 0.05 * torch.ones(N_OBS)) @ "y"

    assert int(_adaptive(1, sharp, 0.05).n_rungs) > int(_adaptive(1).n_rungs)
