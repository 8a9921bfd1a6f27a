"""The port's Rao-Blackwellized particle filter (``genjax_tpu_torch/parallel/
rbpf.py``) against ``genjax_tpu/parallel/rbpf.py`` and the reference's
``tests/parallel/test_rbpf.py``. One device, no process group.

The deterministic Kalman parts: on a model with one regime every particle
carries the same exact filter, so the final means and covariances and the
log marginal (every weight equal) agree with the reference's ``rbpf`` and
with ``dists.lgssm.kalman_filter`` to 1e-5 on the same numpy inputs. In law,
at the reference test's tolerances, on its two-regime switching model
(T = 8): the log evidence of 8 runs at 512 particles against the
enumeration of all 2^8 regime paths (mean within 0.1, the mean evidence
ratio in (0.8, 1.25)), and the weighted final regime against its
enumerated posterior (within 0.05 at 4,096 particles).
"""

from itertools import product

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from scipy.stats import norm as snorm

from genjax_tpu.parallel.rbpf import rbpf as ref_rbpf
from genjax_tpu_torch.dists.lgssm import LGSSMParams, kalman_filter
from genjax_tpu_torch.parallel import RBPFResult, rbpf
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
T = 8
A_REG = np.asarray([0.9, 0.3], np.float32)
Q_SD, R_SD = 0.5, 0.4
TRANS = np.asarray([[0.85, 0.15], [0.2, 0.8]], np.float32)
MU0, P0 = 0.0, 1.0


def make_data(seed=0):
    rng = np.random.RandomState(seed)
    u, z = 0, rng.randn() * np.sqrt(P0)
    ys = []
    for _ in range(T):
        u = rng.choice(2, p=TRANS[u])
        z = A_REG[u] * z + Q_SD * rng.randn()
        ys.append(z + R_SD * rng.randn())
    return np.asarray(ys, np.float32)


YS = make_data()


def kalman_tv(ys, a_seq):
    mean, var, ll = MU0, P0, 0.0
    for y, a in zip(ys, a_seq):
        mean, var = a * mean, a * a * var + Q_SD**2
        s = var + R_SD**2
        ll += snorm.logpdf(y, mean, np.sqrt(s))
        k = var / s
        mean, var = mean + k * (y - mean), (1 - k) * var
    return ll


def _paths():
    for us in product(range(2), repeat=T):
        lp = np.log(TRANS[0, us[0]])
        for t in range(1, T):
            lp += np.log(TRANS[us[t - 1], us[t]])
        yield us, lp + kalman_tv(YS, A_REG[list(us)])


def exact_logz():
    lws = np.asarray([w for _, w in _paths()])
    m = lws.max()
    return float(m + np.log(np.exp(lws - m).sum()))


TRANS_T = torch.from_numpy(TRANS)
A_T = torch.from_numpy(A_REG)


def sample_regime(gen, u_prev, t):
    return (torch.rand((), generator=gen) < TRANS_T[u_prev, 1]).long()


def matrices(u):
    return (A_T[u].reshape(1, 1), torch.tensor([[Q_SD**2]]), torch.tensor([[1.0]]), torch.tensor([[R_SD**2]]))


def run_rbpf(seed, k=512):
    return rbpf(seed, sample_regime, matrices, torch.from_numpy(YS).reshape(-1, 1), n_particles=k,
                init_regime=torch.tensor(0), mu0=torch.tensor([MU0]), P0=torch.tensor([[P0]]), device="cpu")


# ---- one regime: the deterministic Kalman parts

A2 = np.asarray([[0.9, 0.1], [0.0, 0.8]], np.float32)
Q2 = np.asarray([[0.3, 0.05], [0.05, 0.2]], np.float32)
C2 = np.asarray([[1.0, 0.5]], np.float32)
R2 = np.asarray([[0.25]], np.float32)
MU2 = np.asarray([0.1, -0.2], np.float32)
P2 = np.asarray([[1.0, 0.2], [0.2, 0.5]], np.float32)
YS2 = np.random.default_rng(3).normal(size=(6, 1)).astype(np.float32)


def test_one_regime_filters_are_the_kalman_filter_of_the_reference():
    res = rbpf(0, lambda gen, u, t: u, lambda u: tuple(torch.from_numpy(m) for m in (A2, Q2, C2, R2)),
               torch.from_numpy(YS2), n_particles=16, init_regime=torch.tensor(0), mu0=torch.from_numpy(MU2),
               P0=torch.from_numpy(P2), device="cpu")
    ref = ref_rbpf(jr.key(0), lambda k, u, t: u, lambda u: tuple(jnp.asarray(m) for m in (A2, Q2, C2, R2)),
                   jnp.asarray(YS2), n_particles=16, init_regime=jnp.asarray(0), mu0=jnp.asarray(MU2),
                   P0=jnp.asarray(P2))
    assert isinstance(res, RBPFResult)
    np.testing.assert_allclose(res.means.numpy(), np.asarray(ref.means), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res.covs.numpy(), np.asarray(ref.covs), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(res.log_marginal), float(ref.log_marginal), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res.log_weights.numpy(), np.asarray(ref.log_weights), rtol=TOL, atol=TOL)
    # the rbpf's first observation is of z_1 = A z_0 + w: the Kalman filter
    # from the predicted prior
    params = LGSSMParams(A=torch.from_numpy(A2), Q=torch.from_numpy(Q2), C=torch.from_numpy(C2),
                         R=torch.from_numpy(R2), mu0=torch.from_numpy(A2 @ MU2),
                         P0=torch.from_numpy(A2 @ P2 @ A2.T + Q2))
    means, covs, log_z = kalman_filter(params, torch.from_numpy(YS2))
    np.testing.assert_allclose(res.means[0].numpy(), means[-1].numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res.covs[0].numpy(), covs[-1].numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(res.log_marginal), float(log_z), rtol=TOL, atol=TOL)
    assert res.ess_history.shape == (6,) and torch.allclose(res.ess_history, torch.tensor(16.0))


# ---- the switching model in law


def test_log_z_matches_enumeration():
    exact = exact_logz()
    lzs = np.asarray([float(run_rbpf(s).log_marginal) for s in range(8)])
    ratios = np.exp(lzs - exact)
    assert 0.8 < ratios.mean() < 1.25, (lzs, exact)
    np.testing.assert_allclose(lzs.mean(), exact, atol=0.1)


def test_regime_posterior_marginal():
    z = {0: 0.0, 1: 0.0}
    ws = list(_paths())
    m = max(w for _, w in ws)
    for us, w in ws:
        z[us[-1]] += np.exp(w - m)
    p1_exact = z[1] / (z[0] + z[1])
    res = run_rbpf(42, k=4096)
    w = np.exp(res.log_weights.numpy())
    p1 = float(w @ (res.regimes.numpy() == 1).astype(np.float32))
    np.testing.assert_allclose(p1, p1_exact, atol=0.05)


def test_the_reference_agrees_on_the_switching_model():
    """The reference's estimate on the same data and particle count sits
    within the same tolerance of the enumeration as the port's."""
    log_trans = jnp.log(jnp.asarray(TRANS))

    def ref_matrices(u):
        return (jnp.asarray(A_REG)[u].reshape(1, 1), jnp.asarray([[Q_SD**2]]), jnp.asarray([[1.0]]),
                jnp.asarray([[R_SD**2]]))

    run = jax.jit(jax.vmap(lambda k: ref_rbpf(k, lambda kk, u, t: jr.categorical(kk, log_trans[u]), ref_matrices,
                                              jnp.asarray(YS).reshape(-1, 1), n_particles=512,
                                              init_regime=jnp.asarray(0), mu0=jnp.asarray([MU0]),
                                              P0=jnp.asarray([[P0]])).log_marginal))
    lzs = np.asarray(run(jr.split(jr.key(0), 4)))
    port = [float(run_rbpf(100 + s).log_marginal) for s in range(4)]
    assert abs(np.mean(lzs) - np.mean(port)) < 0.15


@pytest.mark.parametrize("threshold", [0.0, 1.1])
def test_resampling_never_or_always(threshold):
    """``ess_threshold`` 0 never resamples (the weights carry the whole
    evidence), above 1 always does: both estimate the same evidence."""
    res = rbpf(7, sample_regime, matrices, torch.from_numpy(YS).reshape(-1, 1), n_particles=2048,
               init_regime=torch.tensor(0), mu0=torch.tensor([MU0]), P0=torch.tensor([[P0]]),
               ess_threshold=threshold, device="cpu")
    assert float(res.log_marginal) == pytest.approx(exact_logz(), abs=0.1)
    assert torch.isfinite(res.means).all() and res.regimes.shape == (2048,)
